"""Headings within 0.05 rad of +-pi through the refining and evaluation
steps that turn them into the ladder's APH, the port against the
reference on the CPU:

  * PRM's heading: the 12-bin encoding and its decode, every TTA
    variant applied forward and `prm_tta_fuse`'s inverse and circular
    mean: equal to the reference's within 1e-5 (raw values, not only
    circular ones), and within 1e-4 of the truth on the circle;
  * the box composition of `test_refine`'s output
    (`refine_features.revert_prm_to_world`: the init box's yaw added back,
    both near +-pi): equal to the reference's within 1e-5;
  * the evaluator's APH: detections whose headings cross the wrap from
    their GT's, `evaluate_detection` equal to the reference's in both AP
    modes, and APH within 2% of AP (the heading term sees no wrap).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from detzero_tpu.data import refine_features as ref_rf
from detzero_tpu.models.refining import target_assign as ref_ta
from detzero_tpu.models.refining import tta as ref_tta
from detzero_tpu.pipeline import evaluator as ref_evaluator
from detzero_tpu_torch.data import refine_features as rf
from detzero_tpu_torch.models.refining import target_assign as ta
from detzero_tpu_torch.models.refining import tta
from detzero_tpu_torch.pipeline import evaluator

from test_torch_wbf_eval import CLASSES, SIZES

WRAP = 0.05


def near_pi(rng, n):
    """Headings within WRAP of +pi or -pi, both sides, in float32."""
    side = np.where(rng.rand(n) < 0.5, 1.0, -1.0)
    return (side * (np.pi - rng.uniform(0, WRAP, n))).astype(np.float32)


def circ(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def test_prm_heading_decode_and_fuse_at_the_wrap():
    rng = np.random.RandomState(0)
    t = 40
    h = near_pi(rng, t)
    c = rng.uniform(-10, 10, (t, 3)).astype(np.float32)
    cs, hs, ref_cs, ref_hs = [], [], [], []
    for v in tta.PRM_DEFAULT_VARIANTS:
        vc, vh = tta.prm_tta_apply_forward(c, h, v)
        rc, rh = ref_tta.prm_tta_apply_forward(jnp.asarray(c), jnp.asarray(h),
                                               v)
        assert np.abs(vh - np.asarray(rh)).max() <= 1e-5, v
        # the model's output path: the heading's bin and residual, decoded
        b, r = ta.encode_heading(torch.from_numpy(vh))
        rb, rr = ref_ta.encode_heading(jnp.asarray(vh))
        assert np.array_equal(b.numpy(), np.asarray(rb)), v
        assert np.array_equal(r.numpy(), np.asarray(rr)), v
        logits = np.eye(12, dtype=np.float32)[b.numpy()]
        res = np.zeros((t, 12), np.float32)
        res[np.arange(t), b.numpy()] = r.numpy()
        dec = ta.decode_heading(torch.from_numpy(logits),
                                torch.from_numpy(res)).numpy()
        ref_dec = np.asarray(ref_ta.decode_heading(logits, res))
        assert np.array_equal(dec, ref_dec), v
        assert circ(dec, vh).max() <= 1e-5, v
        cs.append(vc)
        hs.append(dec)
        ref_cs.append(np.asarray(rc))
        ref_hs.append(ref_dec)
    fc, fh = tta.prm_tta_fuse(np.stack(cs), np.stack(hs))
    rfc, rfh = ref_tta.prm_tta_fuse(jnp.asarray(np.stack(ref_cs)),
                                    jnp.asarray(np.stack(ref_hs)))
    assert np.abs(fh - np.asarray(rfh)).max() <= 1e-5
    assert np.abs(fc - np.asarray(rfc)).max() <= 1e-5
    assert circ(fh, h).max() <= 1e-4
    assert np.abs(fc - c).max() <= 1e-4


@pytest.mark.parametrize("init_yaw", [np.pi - 0.01, -np.pi + 0.02, 3.1])
def test_test_refine_box_composition_at_the_wrap(init_yaw):
    rng = np.random.RandomState(1)
    t = 25
    init_box = np.array([12.0, -7.5, 0.4, 4.5, 2.0, 1.6, init_yaw])
    c = rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    h = near_pi(rng, t)
    got = rf.revert_prm_to_world(c, h, init_box)
    want = ref_rf.revert_prm_to_world(c, h, init_box)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.abs(g - w).max() <= 1e-5
    assert circ(got[1], h + init_yaw).max() <= 1e-5


def wrap_detections(seed=2, n_frames=12):
    """GT headings within WRAP of +-pi; detections jittered by 0.2 m and
    0.03 rad, so about half of them cross the wrap from their GT."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_frames):
        n = rng.randint(4, 10)
        cls = np.array(CLASSES)[rng.randint(0, 3, n)]
        r, a = rng.uniform(5, 60, n), rng.uniform(-np.pi, np.pi, n)
        gb = np.zeros((n, 7))
        gb[:, 0], gb[:, 1] = r * np.cos(a), r * np.sin(a)
        gb[:, 3:6] = [SIZES[k] for k in cls]
        gb[:, 6] = near_pi(rng, n)
        pb = gb + np.c_[rng.randn(n, 2) * 0.2, np.zeros((n, 4)),
                        rng.randn(n, 1) * 0.03]
        pb[:, 6] = (pb[:, 6] + np.pi) % (2 * np.pi) - np.pi
        preds.append({"boxes_lidar": pb, "name": cls, "score": rng.rand(n)})
        gts.append({"gt_boxes": gb, "name": cls,
                    "num_points": rng.randint(20, 500, n)})
    return preds, gts


@pytest.mark.parametrize("ap_mode", ["envelope", "waymo101"])
def test_evaluator_aph_at_the_wrap(ap_mode):
    preds, gts = wrap_detections()
    crossed = sum(int((np.sign(p["boxes_lidar"][:, 6])
                       != np.sign(g["gt_boxes"][:, 6])).sum())
                  for p, g in zip(preds, gts))
    assert crossed >= 10
    want = ref_evaluator.evaluate_detection(preds, gts, CLASSES,
                                            ap_mode=ap_mode)
    got = evaluator.evaluate_detection(preds, gts, CLASSES, ap_mode=ap_mode)
    assert got == want
    m = got["mean"]
    assert m["AP_L2"] > 0.3
    assert m["APH_L2"] >= 0.98 * m["AP_L2"]

"""The last public names of detzero_tpu the port lacked, against the
reference on the CPU:

  * `models/refining/tta.prm_tta_apply_forward` for every variant kind
    (original, the three flips, scales, rotations) on the default PRM
    list and the GRM list's extra scales: centers and headings within 1e-6
    of the reference's, its inverse `prm_tta_fuse` recovering the poses,
    and an unknown variant refused;
  * `ops/nms.multi_class_nms` (one K10 NMS a class, the other classes
    masked invalid) with one threshold and with one a class: keep masks
    equal, kept indices equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from detzero_tpu.models.refining import tta as ref_tta
from detzero_tpu.ops import nms as ref_nms
from detzero_tpu_torch.models.refining import tta
from detzero_tpu_torch.ops import nms

from test_torch_kernels_cpu import _random_boxes

VARIANTS = sorted(set(tta.PRM_DEFAULT_VARIANTS) | set(tta.GRM_DEFAULT_VARIANTS))


def poses(seed, t=13):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-20, 20, (t, 3)).astype(np.float32),
            rng.uniform(-np.pi, np.pi, t).astype(np.float32))


@pytest.mark.parametrize("variant", VARIANTS)
def test_prm_tta_apply_forward(variant):
    c, h = poses(4)
    want_c, want_h = ref_tta.prm_tta_apply_forward(jnp.asarray(c),
                                                   jnp.asarray(h), variant)
    got_c, got_h = tta.prm_tta_apply_forward(c, h, variant)
    assert got_c.dtype == got_h.dtype == np.float32
    assert got_c.shape == c.shape and got_h.shape == h.shape
    assert np.abs(got_c - np.asarray(want_c)).max() <= 1e-6 * 20
    assert np.abs(got_h - np.asarray(want_h)).max() <= 1e-6 * 4
    # the input is left as it was
    assert np.array_equal(c, poses(4)[0])


def test_prm_tta_apply_forward_inverts_through_fuse():
    c, h = poses(5)
    fwd = [tta.prm_tta_apply_forward(c, h, v)
           for v in tta.PRM_DEFAULT_VARIANTS]
    fc, fh = tta.prm_tta_fuse(np.stack([x for x, _ in fwd]),
                              np.stack([y for _, y in fwd]))
    assert np.abs(fc - c).max() <= 1e-4
    d = np.abs(fh - h) % (2 * np.pi)
    assert np.minimum(d, 2 * np.pi - d).max() <= 1e-4
    with pytest.raises(ValueError, match="unknown TTA variant"):
        tta.prm_tta_apply_forward(c, h, "shear_0.1")


@pytest.mark.parametrize("thresh", [0.2, (0.1, 0.3, 0.5)],
                         ids=["one", "per_class"])
def test_multi_class_nms(thresh):
    n, classes = 300, 3
    rng = np.random.RandomState(6)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, [0, 1, 3, 4, 6]] = _random_boxes(11, n)
    boxes[:, 2] = rng.uniform(-1, 1, n)
    boxes[:, 5] = rng.uniform(1, 2, n)
    scores = rng.rand(n).astype(np.float32)
    labels = rng.randint(0, classes, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    kw = dict(pre_max=128, post_max=64)
    want = ref_nms.multi_class_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        classes, thresh, valid_mask=jnp.asarray(valid), **kw)
    n0 = nms.LAUNCHES
    got = nms.multi_class_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(labels), classes, thresh,
        valid_mask=torch.from_numpy(valid), **kw)
    assert nms.LAUNCHES == n0       # the CPU takes the plain versions
    assert len(got) == len(want) == classes
    for c, ((wi, wm), (gi, gm)) in enumerate(zip(want, got)):
        wm, wi = np.asarray(wm), np.asarray(wi)
        assert 0 < wm.sum() < (valid & (labels == c)).sum(), c
        assert np.array_equal(gm.numpy(), wm), c
        assert np.array_equal(gi.numpy()[wm], wi[wm]), c
        assert (labels[gi.numpy()[wm]] == c).all()

"""The two-stage slice (the PDV RoI head) of detzero_tpu_torch against
detzero_tpu on the CPU: tiny geometry, SECOND_STAGE with ROI_BUDGET 16,
ROI_GRID_SIZE 3 and ROI_ATTENTION (as tests/test_pdv_head.py sizes the
reference), float32, weights drawn by the port and converted to flax with
non-trivial BN statistics.

  * the converter's rules for the RoI head's leaves, both ways, and the
    weight-decay mask against the reference's;
  * the 3D backbone's multi-scale tables x_conv3 and x_conv4;
  * the eval forward's proposals, RoI logits and residuals, and `predict`
    end to end.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.core.config import Config
from detzero_tpu.core.optim import wd_mask as jax_wd_mask
from detzero_tpu.models.detection.centerpoint import CenterPoint as JaxCP
from detzero_tpu.models.detection.pdv_head import pdv_predict as jax_refine
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.core.optim import wd_mask
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

from test_torch_convert import CFG, KW, randomize_stats

torch.set_num_threads(1)

TWO_STAGE = {"SECOND_STAGE": True, "ROI_BUDGET": 16, "ROI_GRID_SIZE": 3,
             "ROI_ATTENTION": True}
CFG2 = dict(CFG, **TWO_STAGE)


def two_stage_models(cfg, stats_seed):
    """The port's model with its own random weights and the same weights
    as the reference's variables (BN statistics randomised)."""
    model = CenterPoint(cfg, 3, dtype=torch.float32, device="cpu", **KW)
    model.init_parameters(torch.Generator().manual_seed(0))
    v = randomize_stats(to_flax(model.state_dict()), stats_seed)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    return model, v, JaxCP(Config(cfg), 3, dtype=jnp.float32, **KW)


@pytest.fixture(scope="module")
def both():
    model, v, jm = two_stage_models(CFG2, 7)
    rng = np.random.RandomState(5)
    pts = rng.uniform(-6, 6, (1, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (1, 2048))
    pv = rng.rand(1, 2048) > 0.05
    _, out3d, _ = jax.jit(lambda v_, p, q: jm.apply(
        v_, p, q, train=False, mutable_stats=False))(v, pts, pv)
    return model, v, pts, pv, jax.tree.map(np.asarray, out3d)


def test_convert_round_trip_and_rules(both):
    """Every leaf of the two-stage tree converts and comes back unchanged;
    Dense kernels (in, out) become Linear weights (out, in); the
    attention's 3-D kernels stay in flax's layout, decided by their parent's
    name, and a 3-D kernel under any other parent raises."""
    model, v, *_ = both
    sd = convert_centerpoint(v, model)
    assert len(jax.tree.leaves(v)) == len(model.state_dict())
    roi = v["params"]["roi_head"]
    assert np.array_equal(sd["roi_head.shared_fc.dense0.weight"].numpy(),
                          roi["shared_fc"]["dense0"]["kernel"].T)
    assert np.array_equal(sd["roi_head.grid_attn.query.kernel"].numpy(),
                          roi["grid_attn"]["query"]["kernel"])
    assert sd["roi_head.grid_attn.out.kernel"].shape == (4, 17, 65)
    back = to_flax(sd)
    ref = jax.tree_util.tree_flatten_with_path(v)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert np.array_equal(np.asarray(a), b), path
    bad = {"params": {"roi_head": {"proj": {
        "kernel": np.zeros((3, 4, 5), np.float32)}}}}
    with pytest.raises(ValueError, match="no conversion rule"):
        convert_centerpoint(bad)
    with pytest.raises(ValueError, match="no conversion rule"):
        to_flax({"roi_head.proj.kernel": torch.zeros(3, 4, 5)})


def test_wd_mask_matches_reference(both):
    """The port's weight-decay mask on its parameter names equals the
    reference's on the flax tree, leaf by leaf (the RoI head's Dense,
    attention, LayerNorm and BN leaves included)."""
    model, v, *_ = both
    # each leaf's flag broadcast to the leaf's shape, so it converts
    ref = convert_centerpoint({"params": jax.tree.map(
        lambda b, leaf: np.full(np.shape(leaf), b, np.float32),
        jax_wd_mask(v["params"]), v["params"])})
    got = wd_mask(n for n, _ in model.named_parameters())
    assert set(ref) == set(got)
    for k, r in ref.items():
        assert got[k] == bool(r.reshape(-1)[0]), k
    assert got["roi_head.grid_attn.key.kernel"]
    assert not got["roi_head.LayerNorm_0.scale"]
    assert not got["roi_head.shared_fc.bn1.bias"]


def test_multi_scale_tables(both):
    """x_conv3 (stride 4) and x_conv4 (stride 8) in eval mode: features
    within 1e-4 * max(|ref|, 1) (float32 convs summed in another order),
    cells, masks and zmasks exact, centroids within 1e-6 * max|ref|."""
    model, _, pts, pv, out3d = both
    with torch.no_grad(), model._mode(False):
        got = model.backbone3d(*model.prepare(
            torch.from_numpy(pts), torch.from_numpy(pv)))
    ms_ref = out3d["multi_scale_3d_features"]
    ms = got["multi_scale_3d_features"]
    assert sorted(ms) == ["x_conv3", "x_conv4"]
    for name, r in ((k, ms_ref[k]) for k in ("x_conv3", "x_conv4")):
        g = ms[name]
        mp, nz, c = r["pillar_features"].shape[1:]
        ref = r["pillar_features"].reshape(1, mp * nz, c)
        assert g["features"].shape == ref.shape
        assert np.abs(g["features"].numpy() - ref).max() \
            <= 1e-4 * max(np.abs(ref).max(), 1.0), name
        for k in ("cells", "mask", "zmask"):
            assert np.array_equal(g[k].numpy(), r[k]), (name, k)
        cen = r["centroids"]
        assert np.abs(g["centroids"].numpy() - cen).max() \
            <= 1e-6 * np.abs(cen).max(), name


def test_roi_stage_and_predict(both):
    """Eval forward: proposals equal (mask and labels exact, boxes and
    scores within 1e-5 * max(|ref|, 1)); the RoI head's logits and
    residuals within 1e-3 * max(|ref|, 1), the bound of the first stage's
    head outputs (tests/test_torch_centerpoint.py); `predict` end to end:
    the same mask and labels, refined boxes within 1e-3 and scores within
    1e-4 of the reference's."""
    model, _, pts, pv, out3d = both
    ref = out3d["roi"]
    p, v = torch.from_numpy(pts), torch.from_numpy(pv)
    with torch.no_grad(), model._mode(False):
        _, roi = model.network(*model.prepare(p, v))
    m = ref["roi_mask"]
    assert 0 < m.sum() and np.array_equal(roi["roi_mask"].numpy(), m)
    assert np.array_equal(roi["roi_labels"].numpy()[m], ref["roi_labels"][m])
    for k in ("rois", "roi_scores"):
        a = ref[k][m]
        assert np.abs(roi[k].numpy()[m] - a).max() \
            <= 1e-5 * max(np.abs(a).max(), 1.0), k
    for k in ("cls_logit", "reg_deltas"):
        a = ref[k]
        assert roi[k].shape == a.shape
        assert np.abs(roi[k].numpy() - a).max() \
            <= 1e-3 * max(np.abs(a).max(), 1.0), k
    got = model.predict(p, v)
    boxes, scores = jax.vmap(jax_refine)(ref["cls_logit"], ref["reg_deltas"],
                                         ref["rois"], ref["roi_scores"])
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        "boxes": (1, 16, 7), "scores": (1, 16), "labels": (1, 16),
        "mask": (1, 16)}
    assert np.array_equal(got["mask"].numpy(), m)
    assert np.array_equal(got["labels"].numpy()[m], ref["roi_labels"][m])
    assert np.abs(got["boxes"].numpy()[m] - np.asarray(boxes)[m]).max() \
        <= 1e-3
    assert np.abs(got["scores"].numpy()[m] - np.asarray(scores)[m]).max() \
        <= 1e-4


def test_stage_hook_marks_predict(both):
    """`stage_hook` is called with each stage's name where it begins, in
    the order `predict` runs them, and leaves the outputs unchanged."""
    model, _, pts, pv, _ = both
    p, v = torch.from_numpy(pts), torch.from_numpy(pv)
    ref = model.predict(p, v)
    names = []
    model.stage_hook = names.append
    try:
        got = model.predict(p, v)
    finally:
        model.stage_hook = None
    assert names == ["table", "plan", "row-pad maps", "gather", "stack",
                     "backbone3d", "bev+head", "proposals", "RoI head",
                     "refined boxes"]
    for k, r in ref.items():
        assert torch.equal(got[k], r), k

"""The PDV RoI head of detzero_tpu_torch against detzero_tpu on the CPU:
the RoI targets (kernel K7's plain version inside), the fg/bg subsample on
the reference's own random draws, the RoI loss and refined predictions, and
the PDVHead module with converted weights in eval and train mode on a batch
of two.  Each test states its tolerance."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.models.detection import pdv_head as jpdv
from detzero_tpu.ops import iou3d as jiou3d
from detzero_tpu_torch.convert import convert_centerpoint
from detzero_tpu_torch.models.detection import pdv_head

from test_torch_convert import randomize_stats
from test_torch_pdv_ops import PCR, VS, _boxes7, _t, cloud_plans

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def plans():
    return cloud_plans()


def _rois_and_gt(r, m, seed):
    """r RoIs, the first half jittered copies of valid GT boxes, and m GT
    slots of which the last quarter are invalid."""
    rng = np.random.RandomState(seed)
    gt = _boxes7(seed, m, extent=30.0)
    gv = np.arange(m) < m - m // 4
    rois = _boxes7(seed + 1, r, extent=30.0)
    h = r // 2
    rois[:h] = gt[rng.randint(0, m - m // 4, h)] \
        + rng.randn(h, 7).astype(np.float32) * 0.15
    rois[:h, 3:6] = np.abs(rois[:h, 3:6]) + 0.1
    mask = rng.rand(r) > 0.1
    return rois, mask, gt, gv


@pytest.mark.parametrize("r,m", [(128, 500), (16, 8)])
def test_assign_roi_targets_parity(r, m, monkeypatch):
    """The reference's targets with its IoU on the TPU route (the Pallas
    overlap kernel, in interpret mode here), as it trains: fg mask and
    matched GT exact; the IoU within 1e-4 and the cls target (twice the
    IoU's slope) within 2e-4: XLA's and torch's sin and cos differ in the
    last ulp, which at the 30 m coordinates of these boxes moves a clipped
    area by up to 1e-4 m^2; the residuals within 1e-4 * max|ref| (log and
    division of the same float32 inputs)."""
    monkeypatch.setattr(jiou3d, "_use_pallas", lambda: True)
    rois, mask, gt, gv = _rois_and_gt(r, m, seed=r)
    ref = jpdv.assign_roi_targets(jnp.asarray(rois), jnp.asarray(mask),
                                  jnp.asarray(gt), jnp.asarray(gv))
    got = pdv_head.assign_roi_targets(_t(rois), _t(mask), _t(gt), _t(gv))
    assert np.array_equal(np.asarray(ref["fg_mask"]), got["fg_mask"].numpy())
    assert np.array_equal(np.asarray(ref["matched_gt"]),
                          got["matched_gt"].numpy())
    for k, tol in (("roi_iou", 1e-4), ("cls_target", 2e-4)):
        assert np.abs(np.asarray(ref[k]) - got[k].numpy()).max() <= tol, k
    rt = np.asarray(ref["reg_target"])
    assert np.abs(rt - got["reg_target"].numpy()).max() \
        <= 1e-4 * np.abs(rt).max()
    assert 0 < int(got["fg_mask"].sum()) < r


def _jax_draws(key, n, m):
    """The reference's random numbers inside subsample_rois for `key`."""
    kf, kh, ke, kd = jax.random.split(key, 4)
    u = np.stack([np.asarray(jax.random.uniform(k, (n,)))
                  for k in (kf, kh, ke)])
    return u, np.asarray(jax.random.randint(kd, (m,), 0, 1 << 30))


SUBSAMPLE_CASES = {
    "mixed": np.concatenate([np.full(20, 0.8), np.full(24, 0.3),
                             np.full(20, 0.02)]),
    "no_fg": np.full(64, 0.3),
    "no_bg": np.full(64, 0.9),
    "random": np.random.RandomState(11).rand(64) * 0.9,
}


@pytest.mark.parametrize("case", sorted(SUBSAMPLE_CASES) + ["masked"])
def test_subsample_rois_exact(case):
    """The reference's subsample and the port's on the same draws: idx and
    valid exact."""
    iou = SUBSAMPLE_CASES.get(case, SUBSAMPLE_CASES["mixed"]).astype(
        np.float32)
    mask = np.random.RandomState(12).rand(64) > 0.2
    if case == "masked":
        mask[:] = False
    key = jax.random.PRNGKey(sorted(SUBSAMPLE_CASES).index(case)
                             if case in SUBSAMPLE_CASES else 7)
    ji, jv = jpdv.subsample_rois(key, jnp.asarray(iou), jnp.asarray(mask),
                                 roi_per_image=16)
    u, d = _jax_draws(key, 64, 16)
    ti, tv = pdv_head.subsample_rois(_t(iou), _t(mask), _t(u), _t(d),
                                     roi_per_image=16)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


def test_pdv_loss_and_predict_parity():
    """pdv_loss (total and terms) and its gradients in the logits and
    residuals on the same targets, 1e-5 relative; pdv_predict, 1e-5 *
    max(|ref|, 1)."""
    rois, mask, gt, gv = _rois_and_gt(32, 8, seed=13)
    rng = np.random.RandomState(14)
    cls = rng.randn(32).astype(np.float32)
    reg = (rng.randn(32, 7) * 0.3).astype(np.float32)
    tgt_j = jpdv.assign_roi_targets(jnp.asarray(rois), jnp.asarray(mask),
                                    jnp.asarray(gt), jnp.asarray(gv))
    tgt_t = {k: _t(a) for k, a in tgt_j.items()}

    def jloss(c, r):
        return jpdv.pdv_loss(c, r, tgt_j, jnp.asarray(rois),
                             jnp.asarray(mask))

    (ref, ref_aux), (gc, gr) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(cls),
                                             jnp.asarray(reg))
    c, r = _t(cls).requires_grad_(), _t(reg).requires_grad_()
    got, aux = pdv_head.pdv_loss(c, r, tgt_t, _t(rois), _t(mask))
    got.backward()
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    for k, v in ref_aux.items():
        assert abs(float(aux[k].detach()) - float(v)) \
            <= 1e-5 * max(abs(float(v)), 1e-3), k
    assert float(aux["roi_corner"].detach()) > 0
    assert np.abs(c.grad.numpy() - np.asarray(gc)).max() \
        <= 1e-5 * np.abs(np.asarray(gc)).max()
    assert np.abs(r.grad.numpy() - np.asarray(gr)).max() \
        <= 1e-5 * np.abs(np.asarray(gr)).max()
    scores = rng.rand(32).astype(np.float32)
    jb, js = jpdv.pdv_predict(jnp.asarray(cls), jnp.asarray(reg),
                              jnp.asarray(rois), jnp.asarray(scores))
    tb, ts = pdv_head.pdv_predict(_t(cls), _t(reg), _t(rois), _t(scores))
    for a, b in ((jb, tb), (js, ts)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-5 * max(np.abs(a).max(), 1)


# ---------------------------------------------------------------- PDVHead

@pytest.fixture(scope="module")
def head_case(plans):
    """Two samples on levels 2 and 3 of the reference's plan of one cloud
    (random features on the occupied voxels, sample 1's centroids shifted
    by 5 cm), 16 RoIs each over the cloud, 10 extra features, and a flax
    PDVHead's weights with non-trivial BN statistics, converted into the
    port's PDVHead."""
    jplan, _ = plans
    rng = np.random.RandomState(15)
    grids = [(8, 64, 64), (4, 32, 32), (2, 16, 16), (1, 8, 8)]
    levels = []                    # per level: arrays stacked over samples
    for lvl, c, stride in ((2, 64, 4), (3, 128, 8)):
        e = jplan[lvl]
        zm = np.asarray(e["zmask"])
        cen = np.asarray(e["centroids"])
        levels.append(({
            "features": np.stack([(rng.randn(*zm.shape, c) * zm[..., None])
                                  .reshape(-1, c) for _ in range(2)]
                                 ).astype(np.float32),
            "zmask": np.stack([zm, zm]),
            "lut": np.stack([np.asarray(e["lut"])] * 2),
            "cells": np.stack([np.asarray(e["cells"])] * 2),
            "centroids": np.stack([cen, cen + np.float32(0.05)]),
        }, stride, grids[lvl]))
    rois = np.stack([_boxes7(16 + b, 16, extent=5.0) for b in range(2)])
    roi_mask = rng.rand(2, 16) > 0.2
    extra = rng.randn(2, 16, 10).astype(np.float32)
    kw = dict(pc_range=PCR, voxel_size=VS, grid_size=3, with_attention=True,
              dtype=jnp.float32)
    init = jpdv.PDVHead(use_running_average=False, axis_names=(), **kw)
    v = init.init(jax.random.PRNGKey(1), jnp.asarray(rois[0]),
                  jnp.asarray(roi_mask[0]), _jax_levels(levels, 0),
                  extra_feats=jnp.asarray(extra[0]))
    v = randomize_stats(jax.tree.map(np.asarray, v), 16)
    head = pdv_head.PDVHead(PCR, VS, (64, 128), 10, grid_size=3,
                            with_attention=True)
    head.load_state_dict(convert_centerpoint(v, head), strict=True)
    return kw, v, levels, head, rois, roi_mask, extra


def _jax_levels(levels, b=None):
    """The reference's level dicts: flat features, zmask as `mask`, the
    plan's LUT, cells and centroids; one sample's, or stacked when b is
    None (for vmap; the static stride and grid are added inside)."""
    out = []
    for arrs, stride, grid in levels:
        lv = {"features": arrs["features"],
              "mask": arrs["zmask"].reshape(2, -1), "lut": arrs["lut"],
              "cells": arrs["cells"],
              "centroids": arrs["centroids"].reshape(2, -1, 3)}
        lv = {k: jnp.asarray(a if b is None else a[b]) for k, a in lv.items()}
        if b is not None:
            lv.update(stride=stride, grid_zyx=grid)
        out.append(lv)
    return out


@pytest.mark.parametrize("train", [False, True])
def test_pdv_head_parity(head_case, train):
    """The port's PDVHead on a batch of two against the reference's vmapped
    over the batch axis, whose BN statistics it sums over that axis: cls
    and reg within 1e-4 * max(|ref|, 1) (float32, the same operations in
    another order); in train mode also the updated BN statistics, 1e-5
    relative."""
    kw, v, levels, head, rois, roi_mask, extra = head_case
    net = jpdv.PDVHead(use_running_average=not train, axis_names=("batch",),
                       **kw)
    static = [(stride, grid) for _, stride, grid in levels]

    def one(r, m, e, lvs):
        lvs = [dict(lv, stride=st, grid_zyx=g)
               for lv, (st, g) in zip(lvs, static)]
        return net.apply(v, r, m, lvs, extra_feats=e,
                         mutable=["batch_stats"] if train else False)

    out = jax.vmap(one, axis_name="batch")(
        jnp.asarray(rois), jnp.asarray(roi_mask), jnp.asarray(extra),
        _jax_levels(levels))
    (cls, reg, _), upd = out if train else (out, None)
    t_levels = [dict({k: _t(a) for k, a in arrs.items() if k != "cells"},
                     stride=stride, grid_zyx=grid)
                for arrs, stride, grid in levels]
    head.train(train)
    stats = {k: b.clone() for k, b in head.named_buffers()}
    with torch.no_grad():
        tc, tr = head(_t(rois), _t(roi_mask), t_levels, _t(extra))
    for ref, got in ((cls, tc), (reg, tr)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() \
            <= 1e-4 * max(np.abs(ref).max(), 1.0)
    if train:
        want = convert_centerpoint(
            {"params": {}, "batch_stats": jax.tree.map(
                lambda a: np.asarray(a)[0], upd["batch_stats"])})
        buffers = dict(head.named_buffers())
        for k, r in want.items():
            assert not torch.equal(buffers[k], stats[k]), k
            assert np.abs(buffers[k].numpy() - r.numpy()).max() \
                <= 1e-5 * np.abs(r.numpy()).max(), k
        with torch.no_grad():
            for k, b in buffers.items():
                b.copy_(stats[k])

"""`DOWNSAMPLE_SITE_MODE: union` (spconv's stride-2, padding-1 sites: an
output voxel exists where its 3x3x3 window touches an input voxel) in the
port against detzero_tpu on the CPU, on seeded numpy clouds:

(a) `downsample_pillars(site_mode="union")`: cells, mask, num_pillars and
    zmask bit for bit, once at capacities that hold every site (where the
    union's sites and z occupancy contain the principal ones) and once at a
    capacity the union overflows;
(b) the whole plan (row LUTs, the row-pad layout and
    `augment_plan_rowpad`'s 10 neighbour maps) bit for bit, unsaturated
    and with L0-L2 at their capacities; the second stage's centroids
    within 1e-6 * max|ref|, on a level whose cap dropped principal sites;
(c) CenterPoint under union with converted weights: `pillar_pallas`'s raw
    heads within 1e-3 * max(|ref|, 1), predict's keep masks and labels
    equal, boxes within 1e-3 (tests/test_torch_centerpoint.py's bounds);
    `sorted`'s heads against the reference's voxel route within 2e-3
    (tests/test_torch_sorted_route.py's bound);
(d) one training step under union: tests/test_torch_union_train.py;
(e) an unknown site mode raises ValueError.

The geometry is the other tiny tests' (grid 8 x 64 x 64 of 0.2 x 0.2 x 0.5
m); one module-scope fixture holds each model pair.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.core.config import Config
from detzero_tpu.models.detection.backbone3d_pallas import (
    augment_plan_rowpad as jax_augment,
)
from detzero_tpu.models.detection.backbone3d_pillar import (
    build_pillar_plan as jax_plan,
)
from detzero_tpu.models.detection.center_head import (
    decode_predictions as jax_decode,
)
from detzero_tpu.models.detection.centerpoint import CenterPoint as JaxCP
from detzero_tpu.ops import pillars as jp
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.models.detection.backbone3d_pallas import (
    augment_plan_rowpad,
)
from detzero_tpu_torch.models.detection.backbone3d_pillar import (
    build_pillar_plan,
)
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.ops import pillars as tp

import test_torch_sorted_route as sorted_route
from test_torch_centerpoint import DECODE
from test_torch_convert import CFG, KW, randomize_stats

torch.set_num_threads(1)

GRID = (8, 64, 64)
VS = KW["voxel_size"]
PCR = KW["pc_range"]
# every site fits (L1 holds all 32 x 32 cells); and the inference tests'
# capacities, which 2048 points fill at L0-L2
OPEN_CAPS = (2048, 1024, 512, 256)
FULL_CAPS = CFG["VOXEL_CAPACITIES"]
UNION = {"DOWNSAMPLE_SITE_MODE": "union", "BEV_LAYER_NUMS": (1, 1)}


def cloud(seed, n):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-6, 6, (n, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.8, 1.8, n)
    return pts, rng.rand(n) > 0.05


def tables(pts, valid, budget, mode="dense"):
    j = jp.build_pillar_table(jnp.asarray(pts), jnp.asarray(valid), GRID, VS,
                              PCR, budget, feats_mode=mode)
    t = tp.build_pillar_table(torch.from_numpy(pts), torch.from_numpy(valid),
                              GRID, VS, PCR, budget, feats_mode=mode)
    return j, t


def assert_equal(a, b, what):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                        b.shape)
    assert np.array_equal(a, b), what


def downsampled(j, t, capacity, mode):
    lj = jp.build_row_lut(j["cells"], j["mask"], GRID[1:])
    lt = tp.build_row_lut(t["cells"], t["mask"], GRID[1:])
    return (jp.downsample_pillars(j, GRID[1:], GRID[0], capacity,
                                  site_mode=mode, in_lut=lj),
            tp.downsample_pillars(t, GRID[1:], GRID[0], capacity, lt,
                                  site_mode=mode))


def test_union_sites_contain_principal_when_nothing_is_capped():
    """400 points: 9 candidates a pillar, the L1 capacity never reached."""
    j, t = tables(*cloud(1, 400), 2048)
    dj, dt = downsampled(j, t, 1024, "union")
    for k in ("cells", "mask", "zmask", "coords2d"):
        assert_equal(dj[k], dt[k], k)
    n = int(dt["num_pillars"])
    assert int(dj["num_pillars"]) == n < 1024
    _, pr = downsampled(j, t, 1024, "principal")
    m = int(pr["num_pillars"])
    assert n > m
    u_cells = dt["cells"][:n].numpy()
    pos = np.searchsorted(u_cells, pr["cells"][:m].numpy())
    assert np.array_equal(u_cells[pos], pr["cells"][:m].numpy())
    u_z, p_z = dt["zmask"].numpy()[pos], pr["zmask"][:m].numpy()
    assert (u_z | p_z == u_z).all() and u_z.sum() > p_z.sum()


def test_union_capacity_overflow():
    """2048 points give some 940 union sites at L1 for a capacity of 200:
    the lowest 200 cells stay, with their z windows."""
    j, t = tables(*cloud(2, 2048), 2048)
    dj, dt = downsampled(j, t, 200, "union")
    for k in ("cells", "mask", "zmask", "coords2d"):
        assert_equal(dj[k], dt[k], k)
    assert int(dj["num_pillars"]) == int(dt["num_pillars"]) == 200
    _, wide = downsampled(j, t, 1024, "union")
    assert int(wide["num_pillars"]) > 200
    assert torch.equal(wide["cells"][:200], dt["cells"])


@pytest.mark.parametrize("n,caps", [(2048, OPEN_CAPS), (2048, FULL_CAPS)],
                         ids=["unsaturated", "saturated"])
def test_union_plan_and_maps(n, caps):
    j, t = tables(*cloud(3, n), caps[0])
    jplan = jax.jit(lambda tb: jax_augment(jax_plan(
        tb, GRID, caps, site_mode="union", with_centroids=False,
        with_gather_maps=False), GRID, 128))(j)
    tplan = augment_plan_rowpad(build_pillar_plan(t, GRID, caps,
                                                  site_mode="union"),
                                GRID, 128)
    n_maps = 0
    for lvl, (a, b) in enumerate(zip(jplan, tplan)):
        assert set(a) == set(b), (lvl, set(a) ^ set(b))
        for k in a:
            assert_equal(a[k], b[k], f"level {lvl} {k}")
            n_maps += k.endswith("nbr")
    assert n_maps == 10
    kept = [int(e["mask"].sum()) for e in tplan[:4]]
    full = [k == c for k, c in zip(kept, caps)]
    assert full == ([False] * 4 if caps == OPEN_CAPS
                    else [True, True, False, False])


def test_union_centroids_where_the_cap_drops_principal_sites():
    """The second stage's centroids under union go to principal sites; at
    FULL_CAPS L1 keeps 256 of its union sites, so some L0 voxels find no
    principal site there and add nothing, in both packages."""
    j, t = tables(*cloud(3, 2048), FULL_CAPS[0])
    jplan = jax.jit(lambda tb: jax_plan(
        tb, GRID, FULL_CAPS, site_mode="union", with_centroids=True,
        with_gather_maps=False))(j)
    tplan = build_pillar_plan(t, GRID, FULL_CAPS, site_mode="union",
                              with_centroids=True)
    onx = GRID[2] // 2
    c2d = tplan[0]["coords2d"][tplan[0]["mask"]]
    parent = (c2d[:, 0] // 2) * onx + c2d[:, 1] // 2
    assert not torch.isin(parent, tplan[1]["cells"]).all()
    for lvl in range(4):
        assert_equal(jplan[lvl]["lut"], tplan[lvl]["lut"], f"L{lvl} lut")
        ref = np.asarray(jplan[lvl]["centroids"])
        got = tplan[lvl]["centroids"].numpy()
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), lvl


def test_unknown_site_mode_raises():
    j, t = tables(*cloud(1, 400), 2048)
    lut = tp.build_row_lut(t["cells"], t["mask"], GRID[1:])
    with pytest.raises(ValueError, match="site_mode"):
        tp.downsample_pillars(t, GRID[1:], GRID[0], 256, lut,
                              site_mode="nearest")
    with pytest.raises(ValueError, match="DOWNSAMPLE_SITE_MODE"):
        CenterPoint(dict(CFG, DOWNSAMPLE_SITE_MODE="nearest"), 3,
                    dtype=torch.float32, device="cpu", **KW)


@pytest.fixture(scope="module")
def pallas_pair():
    """The reference's and the port's pillar_pallas CenterPoint under union
    on the inference tests' capacities: the port's seeded weights with
    randomized BN statistics, converted; the reference's heads and its
    decode + NMS of them (== its predict)."""
    cfg = dict(CFG, **UNION)
    rng = np.random.RandomState(5)
    pts = rng.uniform(-6, 6, (1, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (1, 2048))
    pv = rng.rand(1, 2048) > 0.05
    model = CenterPoint(cfg, 3, dtype=torch.float32, device="cpu", **KW)
    model.init_parameters(torch.Generator().manual_seed(0))
    v = randomize_stats(to_flax(model.state_dict()), 7)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    jm = JaxCP(Config(cfg), 3, dtype=jnp.float32, **KW)
    assert jm.site_mode == "union"
    preds, _, _ = jax.jit(lambda v_, p, q: jm.apply(
        v_, p, q, train=False, mutable_stats=False))(v, pts, pv)
    ref = jax.jit(jax.vmap(lambda pr: jax_decode(
        pr, jm.class_ids_each_head, jm.bev_hw, jm.feature_map_stride,
        jm.voxel_size, jm.pc_range, **DECODE)))(preds)
    return (pts, pv, jax.tree.map(np.asarray, preds),
            jax.tree.map(np.asarray, ref), model)


def test_union_pallas_heads(pallas_pair):
    pts, pv, preds, _, model = pallas_pair
    got = model.forward_one(torch.from_numpy(pts[0]), torch.from_numpy(pv[0]))
    for ref_h, got_h in zip(preds, got):
        assert set(ref_h) == set(got_h)
        for k in ref_h:
            a, b = ref_h[k][0], got_h[k].numpy()
            assert a.shape == b.shape, k
            assert np.abs(a - b).max() <= 1e-3 * max(np.abs(a).max(), 1.0), k


def test_union_pallas_predict(pallas_pair):
    pts, pv, _, ref, model = pallas_pair
    got = model.predict(torch.from_numpy(pts), torch.from_numpy(pv), **DECODE)
    m, gm = ref["mask"][0], got["mask"].numpy()[0]
    assert 0 < m.sum() < 256
    assert np.array_equal(gm, m)
    assert np.array_equal(got["labels"].numpy()[0][gm], ref["labels"][0][m])
    assert np.abs(got["boxes"].numpy()[0][gm] - ref["boxes"][0][m]).max() \
        <= 1e-3


def test_union_sorted_route_heads():
    """The port's `sorted` (row-pad backbone, every pillar of a row) against
    the reference's voxel route under union, at capacities no level of
    either fills (voxels or pillars)."""
    cfg = dict(sorted_route.CFG, VOXEL_CAPACITIES=(1024, 1024, 512, 256),
               **UNION)
    kw = sorted_route.KW
    pts, pv, *_ = sorted_route.parity_inputs()
    jm = JaxCP(Config(cfg), 3, dtype=jnp.float32, **kw)
    assert (jm.backend, jm.site_mode) == ("sorted", "union")
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), pts, pv))
    preds, _, _ = jax.jit(lambda v_, p, q: jm.apply(
        v_, p, q, train=False, mutable_stats=False))(v, pts, pv)
    model = CenterPoint(cfg, 3, dtype=torch.float32, device="cpu", **kw)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    for i in range(len(pts)):
        plan = model.build_plan(model.build_table(
            torch.from_numpy(pts[i]), torch.from_numpy(pv[i])))
        assert all(int(e["mask"].sum()) < c for e, c in
                   zip(plan, cfg["VOXEL_CAPACITIES"]))
        got = model.forward_one(torch.from_numpy(pts[i]),
                                torch.from_numpy(pv[i]))
        for ref_h, got_h in zip(preds, got):
            for k in ref_h:
                np.testing.assert_allclose(
                    got_h[k].numpy(), np.asarray(ref_h[k])[i], rtol=2e-3,
                    atol=2e-3, err_msg=k)

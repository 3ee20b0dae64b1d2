"""detzero_tpu_torch pillar table and plan against detzero_tpu on the tiny
geometry (grid (8, 64, 64), capacities (512, 256, 128, 64), 2048 points):
every integer output exactly equal, float means within 1e-6 relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.models.detection.backbone3d_pallas import (
    augment_plan_rowpad as jax_augment,
)
from detzero_tpu.models.detection.backbone3d_pillar import (
    build_pillar_plan as jax_plan,
)
from detzero_tpu.ops import pillars as jp
from detzero_tpu_torch.models.detection.backbone3d_pallas import (
    augment_plan_rowpad,
)
from detzero_tpu_torch.models.detection.backbone3d_pillar import (
    build_pillar_plan,
)
from detzero_tpu_torch.ops import pillars as tp

torch.set_num_threads(1)

GRID = (8, 64, 64)
VS = (0.2, 0.2, 0.5)
PCR = (-6.4, -6.4, -2.0, 6.4, 6.4, 2.0)
CAPS = (512, 256, 128, 64)


def _points(seed, n=2048):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-6, 6, (n, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.8, 1.8, n)
    pts[:20, :3] = 50.0                  # out of range: dropped
    valid = rng.rand(n) > 0.1
    return pts, valid


def _tables(pts, valid, mode, budget=512):
    j = jp.build_pillar_table(jnp.asarray(pts), jnp.asarray(valid), GRID, VS,
                              PCR, budget, feats_mode=mode)
    t = tp.build_pillar_table(torch.from_numpy(pts), torch.from_numpy(valid),
                              GRID, VS, PCR, budget, feats_mode=mode)
    return j, t


def _assert_equal(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("mode", ["dense", "stream"])
@pytest.mark.parametrize("budget", [512, 300])
def test_pillar_table_parity(mode, budget):
    """budget 300 < the ~1000 occupied cells: the highest cells drop."""
    pts, valid = _points(0)
    j, t = _tables(pts, valid, mode, budget)
    for k in ("cells", "coords2d", "mask", "zmask"):
        _assert_equal(j[k], t[k], k)
        assert np.asarray(j[k]).dtype == t[k].numpy().dtype, k
    assert int(j["num_pillars"]) == int(t["num_pillars"]) == budget
    if mode == "dense":
        a, b = np.asarray(j["feats"]), t["feats"].numpy()
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
    else:
        # the reference packs (lane, z) into (NQ*2, 128) lane tiles
        meta = np.asarray(j["stream"]["meta"])
        nq = meta.shape[0] // 2
        m = meta.reshape(nq, 2, 128).transpose(0, 2, 1).reshape(-1, 2)
        _assert_equal(m[:len(pts), 0], t["stream"]["lane"], "lane")
        _assert_equal(m[:len(pts), 1], t["stream"]["z"], "z")
        _assert_equal(j["stream"]["wstart"], t["stream"]["wstart"], "wstart")


@pytest.mark.parametrize("row_budget", [128, 8])
def test_plan_and_rowpad_parity(row_budget):
    """All levels, all keys (LUTs, slots, gidx, zmasks and the 10 neighbour
    maps) exactly equal; row_budget 8 overflows rows."""
    pts, valid = _points(1)
    j, t = _tables(pts, valid, "dense")
    jplan = jax.jit(lambda tb: jax_augment(
        jax_plan(tb, GRID, CAPS, with_centroids=False,
                 with_gather_maps=False), GRID, row_budget))(j)
    tplan = augment_plan_rowpad(build_pillar_plan(t, GRID, CAPS), GRID,
                                row_budget)
    assert len(jplan) == len(tplan) == 5
    n_nbr = 0
    for lvl, (a, b) in enumerate(zip(jplan, tplan)):
        assert set(a) == set(b), (lvl, set(a) ^ set(b))
        for k in a:
            _assert_equal(a[k], b[k], f"level {lvl} {k}")
            n_nbr += k.endswith("nbr")
    assert n_nbr == 10


def test_downsample_and_helpers_parity():
    pts, valid = _points(2)
    j, t = _tables(pts, valid, "dense")
    lut_j = jp.build_row_lut(j["cells"], j["mask"], GRID[1:])
    lut_t = tp.build_row_lut(t["cells"], t["mask"], GRID[1:])
    _assert_equal(lut_j, lut_t, "lut")
    dj = jp.downsample_pillars(j, GRID[1:], GRID[0], 200, in_lut=lut_j)
    dt = tp.downsample_pillars(t, GRID[1:], GRID[0], 200, in_lut=lut_t)
    for k in ("cells", "coords2d", "mask", "zmask"):
        _assert_equal(dj[k], dt[k], k)
    assert int(dj["num_pillars"]) == int(dt["num_pillars"])
    _assert_equal(jp.halve_zmask(j["zmask"], 4), tp.halve_zmask(t["zmask"], 4),
                  "halve_zmask")
    # densify and the z-conv on the compact table
    feats = np.array(j["feats"]).reshape(512, -1)
    _assert_equal(
        jp.densify_pillars(jnp.asarray(feats), j["cells"], j["mask"],
                           GRID[1:]),
        tp.densify_pillars(torch.from_numpy(feats), t["cells"], t["mask"],
                           GRID[1:]), "densify")
    rng = np.random.RandomState(3)
    w = rng.randn(3, 5, 7).astype(np.float32)
    zo = np.array(jp.halve_zmask(j["zmask"], 4))
    a = jp.z_conv(j["feats"], jnp.asarray(zo), jnp.asarray(w), 2, 4)
    b = tp.z_conv(t["feats"], torch.from_numpy(zo), torch.from_numpy(w), 2, 4)
    a = np.asarray(a)
    assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()

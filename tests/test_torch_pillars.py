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
    augment_plan_rowpad, stack_plans,
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


# ---------------------------------------------------------------------------
# The gather-only backwards of the backbone's exit relayouts
# ---------------------------------------------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(x):
    """The bit pattern of a float tensor, for exact comparisons."""
    return x.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[x.dtype])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _stacked_layout(row_budget=4, n=2, n_points=400):
    """Two samples' row-pad maps at level 0, stacked as `stack_plans`
    stacks them: slots offset by a sample's slots, gidx by its compact
    rows.  Few points, so the tables end in dead rows; a row budget of 4,
    so some BEV rows drop pillars."""
    lays, tables = [], []
    for b in range(n):
        pts, valid = _points(10 + b, n_points)
        t = tp.build_pillar_table(torch.from_numpy(pts),
                                  torch.from_numpy(valid), GRID, VS, PCR, 512)
        tables.append(t)
        lays.append(tp.rowpad_layout(t["cells"], t["mask"], GRID[1:],
                                     row_budget))
    mp, rows = 512, GRID[1] * row_budget
    lay = {"slot": torch.cat([l["slot"] + b * rows
                              for b, l in enumerate(lays)]),
           "keep": torch.cat([l["keep"] for l in lays]),
           "gidx": torch.cat([l["gidx"] + b * mp
                              for b, l in enumerate(lays)]),
           "gvalid": torch.cat([l["gvalid"] for l in lays])}
    mask = torch.cat([t["mask"] for t in tables])
    assert (mask & ~lay["keep"]).any()        # a row over the budget
    assert (~mask).any()                      # rows past the live count
    return lay, tables


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_from_rowpad_gather_vjp(dtype):
    """The forward is the plain gather bit for bit; the backward equals
    autograd of plain indexing and the reference's `from_rowpad_g` VJP."""
    tdt, jdt = DTYPES[dtype]
    lay, _ = _stacked_layout()
    rb = lay["gidx"].shape[1]
    rng = np.random.RandomState(4)
    rp = torch.from_numpy(rng.randn(2 * GRID[1], 6, rb).astype(
        np.float32)).to(tdt).requires_grad_()
    g = torch.from_numpy(rng.randn(1024, 6).astype(np.float32)).to(tdt)
    maps = (lay["slot"], lay["keep"])
    inv = (lay["gidx"], lay["gvalid"])

    before = tp.GATHER_VJPS
    out = tp.from_rowpad(rp, *maps, *inv)
    plain = tp._from_rowpad(rp, *maps, 0.0)
    assert torch.equal(_bits(out), _bits(plain))
    (got,) = torch.autograd.grad(out, rp, g)
    (want,) = torch.autograd.grad(plain, rp, g)
    assert tp.GATHER_VJPS == before + 1
    assert got.dtype == tdt and torch.equal(got, want)

    jmaps = [jnp.asarray(m.numpy()) for m in maps + inv]
    _, vjp = jax.vjp(lambda r: jp.from_rowpad_g(r, *jmaps),
                     jnp.asarray(rp.detach().float().numpy(), jdt))
    (ref,) = vjp(jnp.asarray(g.float().numpy(), jdt))
    assert np.array_equal(_np(ref), got.float().numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_densify_gather_vjp(dtype):
    """The same for `densify_pillars`, one sample's map, dead rows
    included."""
    tdt, jdt = DTYPES[dtype]
    _, tables = _stacked_layout()
    t = tables[0]
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(512, 7).astype(np.float32)).to(
        tdt).requires_grad_()
    g = torch.from_numpy(rng.randn(*GRID[1:], 7).astype(np.float32)).to(tdt)

    before = tp.GATHER_VJPS
    out = tp.densify_pillars(feats, t["cells"], t["mask"], GRID[1:])
    plain = tp._densify(feats, t["cells"], t["mask"], GRID[1:])
    assert torch.equal(_bits(out), _bits(plain))
    (got,) = torch.autograd.grad(out, feats, g)
    (want,) = torch.autograd.grad(plain, feats, g)
    assert tp.GATHER_VJPS == before + 1
    assert got.dtype == tdt and torch.equal(got, want)
    assert not got[~t["mask"]].any()

    cells, mask = jnp.asarray(t["cells"].numpy()), jnp.asarray(
        t["mask"].numpy())
    _, vjp = jax.vjp(lambda f: jp.densify_pillars(f, cells, mask, GRID[1:]),
                     jnp.asarray(feats.detach().float().numpy(), jdt))
    (ref,) = vjp(jnp.asarray(g.float().numpy(), jdt))
    assert np.array_equal(_np(ref), got.float().numpy())


@pytest.mark.parametrize("multi_scale", [False, True])
def test_stack_plans_inverse_maps(multi_scale):
    """The stacked rp_gidx/rp_gvalid invert the stacked rp_slot/rp_keep at
    every level whose slots `stack_plans` stacks: from_rowpad of
    rowpad_gather gives back the kept rows of both samples, zeros
    elsewhere."""
    plans = []
    for b in range(2):
        pts, valid = _points(20 + b, 1200)
        t = tp.build_pillar_table(torch.from_numpy(pts),
                                  torch.from_numpy(valid), GRID, VS, PCR,
                                  512)
        plans.append(augment_plan_rowpad(build_pillar_plan(
            t, GRID, CAPS, with_centroids=multi_scale), GRID, 4))
    st = stack_plans(plans)
    levels = (2, 3) if multi_scale else (3,)
    assert [lvl for lvl in range(4) if "rp_gidx" in st[lvl]] == list(levels)
    rng = np.random.RandomState(6)
    dropped = 0
    for lvl in levels:
        e = st[lvl]
        v = torch.from_numpy(rng.randn(e["rp_keep"].shape[0], 5).astype(
            np.float32))
        rp = tp.rowpad_gather(v, e["rp_gidx"], e["rp_gvalid"])
        assert rp.shape[0] == 2 * plans[0][lvl]["rp_gidx"].shape[0]
        back = tp.from_rowpad(rp, e["rp_slot"], e["rp_keep"], e["rp_gidx"],
                              e["rp_gvalid"])
        keep = e["rp_keep"]
        assert keep[:len(keep) // 2].any() and keep[len(keep) // 2:].any()
        assert torch.equal(back[keep], v[keep])
        assert not back[~keep].any()
        dropped += int((torch.cat([p[lvl]["mask"] for p in plans])
                        & ~keep).sum())
    assert dropped > 0                        # the budget of 4 drops pillars


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backbone_gather_vjps(dtype, monkeypatch):
    """One train-mode backward of the 3D backbone at batch 2 takes the
    gather-only backward 1 + 2 times (the L3 from_rowpad, one densify a
    sample), and every leaf's gradient equals autograd of plain indexing
    through the same two gathers."""
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    from test_torch_convert import CFG, KW
    tdt = DTYPES[dtype][0]
    # a row budget of 16 keeps the plain convs quick and drops pillars
    model = CenterPoint(dict(CFG, PILLAR_ROW_BUDGET=16), 3, dtype=tdt,
                        device="cpu", **KW)
    model.init_parameters(torch.Generator().manual_seed(0))
    model.train()
    bb = model.backbone3d
    pts = np.stack([_points(30 + b)[0] for b in range(2)])
    rp, plan = model.prepare(torch.from_numpy(pts),
                             torch.ones(pts.shape[:2], dtype=torch.bool))

    def grads():
        bev = bb(rp, plan)["spatial_features"]
        ct = torch.from_numpy(np.random.RandomState(7).randn(
            *bev.shape).astype(np.float32)).to(bev.dtype)
        return torch.autograd.grad(bev, list(bb.parameters()), ct)

    before = tp.GATHER_VJPS
    got = grads()
    assert tp.GATHER_VJPS == before + 1 + 2
    monkeypatch.setattr(tp, "from_rowpad", lambda rp, slot, keep, gidx,
                        gvalid, fill=0.0: tp._from_rowpad(rp, slot, keep,
                                                          fill))
    monkeypatch.setattr(tp, "densify_pillars", tp._densify)
    want = grads()
    assert tp.GATHER_VJPS == before + 1 + 2
    names = [k for k, _ in bb.named_parameters()]
    assert len(names) == len(got) == len(want)
    for k, a, b in zip(names, got, want):
        assert torch.equal(a, b), k
    assert names[0] == f"{bb.stem}.kernel" and got[0].abs().max() > 0

"""What the redesigned kernels K8 and K3/K7 rely on, checked on the CPU.

K8 (`csrc/rowpad_nbr.cu`) builds a sample's 10 neighbour maps in one launch
and ranks each tap by a lower-bound binary search instead of the reference's
count; the two agree only because every x-coordinate row of the plan is
sorted, its live cells unique, its NBR_BIG fill last.  K3/K7
(`csrc/iou_bev.cu`) cull the pairs whose clip result the clip's own side
tests on A's corners already tell (`iou_bev.clip_class_plain`).  Here: the
rows' order on the tiny plans, a torch mirror of the kernel's search
against the count and the Pallas kernel in interpret mode, the cull
against the plain clip (and the reference's Pallas kernel in interpret
mode) on random and adversarial pairs, and the one-launch wrapper on CPU
tensors against the JAX plan's maps.  The kernels themselves are compared
with the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

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
from detzero_tpu.ops import pallas_iou
from detzero_tpu.ops import pallas_pillar as ppk
from detzero_tpu_torch.models.detection.backbone3d_pallas import (
    augment_plan_rowpad,
)
from detzero_tpu_torch.models.detection.backbone3d_pillar import (
    build_pillar_plan,
)
from detzero_tpu_torch.ops import iou_bev, pillars, rowpad_nbr

from test_torch_pillars import CAPS, GRID, _points, _tables
from torch_iou_cases import FAMILIES, pair_set

torch.set_num_threads(1)

INT_MAX = 2 ** 31 - 1
BUDGETS = [8, 128]


def _cases(xq):
    """The plan's 10 maps as (level, key, (xq, x_in, mode)), in
    `augment_plan_rowpad`'s order."""
    cases = [(lvl, "rp_nbr", (xq[lvl], xq[lvl], "subm")) for lvl in range(4)]
    for lvl in range(3):
        cases += [(lvl, "rp_down_nbr", (xq[lvl + 1], xq[lvl], "down")),
                  (lvl, "rp_up_nbr", (xq[lvl], xq[lvl + 1], "up"))]
    return cases


@pytest.fixture(scope="module", params=BUDGETS)
def plans(request):
    """(row budget, the JAX plan, the port's plan, the port's x-coordinate
    rows per level) of one tiny cloud (~1000 occupied cells against the
    512-pillar budget; at row budget 8 rows overflow)."""
    b = request.param
    pts, valid = _points(1)
    j, t = _tables(pts, valid, "dense")
    jplan = jax.jit(lambda tb: jax_augment(
        jax_plan(tb, GRID, CAPS, with_centroids=False,
                 with_gather_maps=False), GRID, b))(j)
    tplan = augment_plan_rowpad(build_pillar_plan(t, GRID, CAPS), GRID, b)
    xq = [pillars.rowpad_xcoords(e["coords2d"][:, 1], e["rp_gidx"],
                                 e["rp_gvalid"]) for e in tplan[:4]]
    return b, jplan, tplan, xq


def test_plan_xcoord_rows_sorted(plans):
    """(a) Every level's x-coordinate rows are non-decreasing, their live
    cells unique (strictly increasing) and the NBR_BIG fill last; at row
    budget 8 some rows are full (they kept their first 8 pillars)."""
    b, _, _, xq = plans
    n_full = 0
    for lvl, x in enumerate(xq):
        assert x.dtype == torch.int32 and x.shape[1] == b
        live = x < pillars.NBR_BIG
        assert bool((x[:, 1:] >= x[:, :-1]).all()), lvl
        assert bool(((x[:, 1:] > x[:, :-1]) | ~live[:, 1:]).all()), lvl
        assert bool((live[:, 1:] <= live[:, :-1]).all()), lvl
        assert bool((x[live] >= 0).all()) and bool((x[~live]
                                                    == pillars.NBR_BIG).all())
        n_full += int(live.all(1).sum())
    assert (n_full > 0) == (b == 8)


def _search_map(xq, x_in, mode):
    """K8's kernel (csrc/rowpad_nbr.cu) step for step in torch: the three
    target rows padded with INT_MAX to a power of two, the branchless lower
    bound, one equality test at the found rank."""
    ny_out, b_out = xq.shape
    ny_in, b_in = x_in.shape
    pad = 1 << max(b_in - 1, 0).bit_length()
    rows = torch.cat([x_in.long(), torch.full((ny_in, pad - b_in), INT_MAX)],
                     1)
    i = torch.arange(ny_out)
    q = xq.long()
    out = torch.full((ny_out, pillars.NBR_ROWS, b_out), b_in,
                     dtype=torch.int32)
    for j in range(9):
        d, dx = j // 3, j % 3 - 1
        s = (2 * i if mode == "down" else i) + d - 1
        if mode == "up":
            rv = (s >= 0) & (s % 2 == 0) & (s // 2 < ny_in)
            s = torch.where(s >= 0, s // 2, 0)
        else:
            rv = (s >= 0) & (s < ny_in)
        row = rows[s.clamp(0, ny_in - 1)]                  # (ny_out, pad)
        ok = (q < pillars.NBR_BIG) & rv[:, None]
        if mode == "subm":
            xp = q + dx
        elif mode == "down":
            xp = 2 * q + dx
        else:
            num = q + dx + 2                                # >= 1
            xp = num // 2 - 1
            ok &= num % 2 == 0
        base = torch.zeros_like(q)
        half = pad // 2
        while half:
            base += torch.where(row.gather(1, base + half - 1) < xp, half, 0)
            half //= 2
        rank = base + (row.gather(1, base) < xp).long()
        found = ok & (rank < b_in) & (
            row.gather(1, rank.clamp(max=pad - 1)) == xp)
        out[:, j] = torch.where(found, rank, b_in).to(torch.int32)
    return out


def test_nbr_search_mirror_equals_count(plans):
    """(b) The kernel's binary search gives the reference's count on every
    element of all 10 maps: against `pillars.rowpad_nbr_rank` and against
    `pallas_pillar.rowpad_nbr` in interpret mode."""
    b, _, _, xq = plans
    n_found = 0
    for lvl, key, (q, x_in, mode) in _cases(xq):
        got = _search_map(q, x_in, mode)
        ref = pillars.rowpad_nbr_rank(q, x_in, mode)
        assert torch.equal(got, ref), (lvl, key)
        kern = np.asarray(ppk.rowpad_nbr(jnp.asarray(q.numpy()),
                                         jnp.asarray(x_in.numpy()),
                                         mode=mode, interpret=True))
        assert np.array_equal(got.numpy(), kern), (lvl, key)
        n_found += int((ref[:, :9] < b).sum())
    assert n_found > 0


def test_rowpad_nbr_maps_cpu_vs_jax(plans):
    """(d) The one-launch wrapper on CPU tensors (the plain version map by
    map, no launch) gives the JAX plan's 10 maps, and `augment_plan_rowpad`
    takes its maps from it."""
    b, jplan, tplan, xq = plans
    n0 = rowpad_nbr.LAUNCHES
    cases = _cases(xq)
    maps = rowpad_nbr.rowpad_nbr_maps([c for _, _, c in cases])
    assert rowpad_nbr.LAUNCHES == n0 and len(maps) == 10
    for (lvl, key, (q, _, _)), got in zip(cases, maps):
        ref = np.asarray(jplan[lvl][key])
        assert got.dtype == torch.int32
        assert got.shape == (q.shape[0], pillars.NBR_ROWS, b) == ref.shape
        assert np.array_equal(got.numpy(), ref), (lvl, key)
        assert torch.equal(tplan[lvl][key], got), (lvl, key)
    assert rowpad_nbr.rowpad_nbr_maps([]) == []


def test_rowpad_nbr_maps_checks_its_input():
    """The wrapper refuses more maps than the kernel's descriptors hold and
    a bad mode, before it needs a card (meta tensors)."""
    meta = dict(device="meta", dtype=torch.int32)
    case = (torch.empty(4, 8, **meta), torch.empty(4, 8, **meta), "subm")
    with pytest.raises(ValueError, match="at most"):
        rowpad_nbr.rowpad_nbr_maps([case] * (rowpad_nbr.MAX_MAPS + 1))
    with pytest.raises(ValueError, match="mode"):
        rowpad_nbr.rowpad_nbr_maps([case[:2] + ("side",)])
    with pytest.raises(ValueError, match="CUDA"):
        rowpad_nbr.rowpad_nbr_maps([case] * 10)


# ------------------------------------------------------------- K3/K7 cull

# the reference's Pallas kernel in interpret mode compiles once per input
# shape (~15 s), so every family's sets are padded to one
CULL_PAD = 256


def _pallas_overlap(a, b):
    """The reference's Pallas overlap of a x b (interpret mode), both sets
    padded with zero rows to CULL_PAD and the result cut back: each pair's
    entry depends on that pair alone, so the padding changes none."""
    pa, pb = (np.concatenate([x, np.zeros((CULL_PAD - len(x), 5), x.dtype)])
              for x in (a, b))
    ov = pallas_iou.boxes_overlap_bev(jnp.asarray(pa), jnp.asarray(pb))
    return np.asarray(ov)[:len(a), :len(b)]


@pytest.mark.parametrize("name", FAMILIES)
def test_iou_cull_never_culls_a_nonzero_pair(name):
    """(c) The matrix kernel's cull against the plain clip on every (A, B)
    combination of the set: a pair it culls (CLIP_EMPTY) has overlap
    exactly 0, a pair it takes as A's own quad (CLIP_INSIDE) has exactly
    that area, and so every pair with a nonzero overlap that A's quad does
    not give goes to the clip.  The reference's Pallas kernel (interpret
    mode) is 0 wherever the cull culls, and agrees with the plain clip
    within 1e-5 of the largest area, except on the 'band' family: there A's
    corners sit on the on-edge rule's threshold, where the last bit of
    XLA's sin/cos against torch's puts a corner on the other side of it."""
    a, b = pair_set(name)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cls = iou_bev.clip_class_plain(ta, tb)
    ov = iou_bev.boxes_overlap_bev_plain(ta, tb)
    quad = iou_bev.boxes_overlap_bev_plain(
        ta, torch.zeros(1, 5))[:, 0]          # a zero-size B keeps A whole
    empty = cls == iou_bev.CLIP_EMPTY
    inside = cls == iou_bev.CLIP_INSIDE
    assert cls.shape == ov.shape == (len(a), len(b))
    assert bool((ov[empty] == 0).all())
    assert torch.equal(ov[inside], quad[:, None].expand_as(ov)[inside])
    ref = _pallas_overlap(a, b)
    assert (ref[empty.numpy()] == 0).all()
    if name != "band":
        assert np.abs(ref - ov.numpy()).max() <= 1e-5 * max(float(ov.max()),
                                                            1)
    n = {k: int((cls == v).sum()) for k, v in (
        ("empty", iou_bev.CLIP_EMPTY), ("inside", iou_bev.CLIP_INSIDE),
        ("clip", iou_bev.CLIP_NEEDED))}
    if name == "random":
        assert n["empty"] > 0.7 * cls.numel() and n["clip"] > 0
        assert int((ov > 0).sum()) > len(a)
    if name in ("zero_size", "tiny_edges"):
        assert n["inside"] > 0
    if name == "far_degenerate":
        d = torch.diagonal(ov)
        assert bool((d > 0).all())
        assert bool((torch.diagonal(cls) == iou_bev.CLIP_NEEDED).all())


def test_iou_cull_mirror_matches_the_pairwise_corner_tests():
    """The cull's classes on the diagonal of an N x N set equal what the
    matched-pair corner lists give (the class depends only on the pair),
    and the IoU wrapper on CPU tensors is the plain version."""
    a, b = pair_set("band")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cls = iou_bev.clip_class_plain(ta, tb)
    pair, tested = iou_bev._clip_class(iou_bev._corners(ta),
                                       iou_bev._corners(tb), (len(a),))
    assert torch.equal(torch.diagonal(cls), pair)
    assert bool(((tested >= 1) & (tested <= 4)).all())
    assert torch.equal(iou_bev.boxes_iou_bev(ta, tb),
                       iou_bev.boxes_iou_bev_plain(ta, tb))

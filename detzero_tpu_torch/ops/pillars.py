"""Z-dense pillar tables, the row-padded conv layout and its neighbour maps.

Port of the parts of `detzero_tpu/ops/pillars.py` that CenterPoint runs:
the pillar table (both feature modes), the row LUT, downsampling in both
site modes, the row-padded layout with its rank-by-count neighbour maps,
the (3,1,1) z-conv, the BEV densify, and the PDV second stage's voxel query
through the row LUT.  Every function returns the same
values as its JAX counterpart; integer outputs are bit-identical.

Integers stay int32 where the reference computes in int32, so that the
`INVALID_ID` and `NBR_BIG` sentinels compare the same way.  Sorts that the
reference relies on being stable are `stable=True` here.

The backbone's two exit relayouts, `from_rowpad` and `densify_pillars`, have
the reference's gather-only backward: autograd of a plain `x[idx]` is an
accumulating `index_put_`, which CUDA runs as a sort and walks every run of
one index on one warp, and both gathers point their many empty rows at one
index.  `GATHER_VJPS` counts the backwards taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

I32 = torch.int32
INVALID_ID = 2**31 - 1
# "no pillar in this rowpad slot" in the x-coordinate tables; small enough
# that 2 * NBR_BIG + 1 (the 'down' query transform) stays in int32
NBR_BIG = 1 << 28
# nbr tensors are (ny, NBR_ROWS, B) int32: rows 0..8 hold tap ranks
NBR_ROWS = 16
# the 3x3 BEV window's offsets (dy, dx), row-major
BEV_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
# downsampling's output sites (`downsample_pillars`)
SITE_MODES = ("principal", "union")
# backwards of `from_rowpad` and `densify_pillars` run
GATHER_VJPS = 0


def _arange(n, like):
    return torch.arange(n, dtype=I32, device=like.device)


def _run_starts(s):
    """True where a run of equal values in `s` begins."""
    first = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    return first


def _cumsum32(x):
    return torch.cumsum(x.to(I32), 0, dtype=I32)


def segment_sum_sorted(values, seg, num_segments):
    """Sum the rows of `values` into `num_segments` bins; `seg` must be
    nondecreasing.  Differences of a float64 prefix sum at the run ends:
    deterministic on every device, unlike a float `index_add_` on CUDA.
    The columns are scanned laid end to end as one vector, each relative to
    its column's start: a prefix sum down the rows of a narrow matrix runs
    one thread per column on CUDA (PERF.md, PR 3), the flat one is a single
    parallel scan."""
    out = values.new_zeros((num_segments,) + values.shape[1:],
                           dtype=torch.float64)
    n = seg.shape[0]
    if n == 0:
        return out.to(values.dtype)
    cols = values.double().reshape(n, -1).t()
    flat = torch.cumsum(cols.reshape(-1), 0).reshape(cols.shape)
    start = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    csum = (flat - start[:, None]).t().reshape(values.shape)
    last = torch.ones(n, dtype=torch.bool, device=seg.device)
    last[:-1] = seg[1:] != seg[:-1]
    ends = csum[last]
    starts = torch.cat([ends.new_zeros((1,) + ends.shape[1:]), ends[:-1]])
    out[seg[last].long()] = ends - starts
    return out.to(values.dtype)


# ---------------------------------------------------------------------------
# Pillar table
# ---------------------------------------------------------------------------

def build_pillar_table(points, valid, grid_zyx, voxel_size, pc_range,
                       max_pillars, feats_mode="dense"):
    """Points (P, 3+F) f32 -> z-dense pillar table (one stable sort).

    Returns a dict with cells (MP,) int32 ascending (INVALID_ID pad),
    coords2d (MP, 2), mask (MP,), num_pillars (), zmask (MP, nz), and
      * feats_mode "dense": feats (MP, nz, 3+F) per-voxel means;
      * feats_mode "stream": stream = {payload (P, F+1) sorted features plus
        the in-budget weight column, lane (P,) pillar rank inside its BEV
        row, z (P,), wstart (ny+1,) per-row windows} for
        `ops.stream_vfe.stream_rowpad_feats`.  The reference packs the same
        columns into (NQ*C, 128) lane tiles for the TPU; the port keeps them
        as they are.
    Pillars past the budget are dropped, highest cell ids first.
    """
    nz, ny, nx = grid_zyx
    if points.dtype != torch.float32:
        raise TypeError(f"build_pillar_table needs float32 points, got "
                        f"{points.dtype}")
    if ny * nx >= (1 << 24):
        raise ValueError(f"BEV grid {ny}x{nx} overflows the f32-exact "
                         f"integer range the reference relies on "
                         f"(need ny*nx < 2^24)")
    dev = points.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    idx = torch.floor((points[:, :3] - lo) / vs).to(I32)      # xyz order
    ok = (valid & (idx[:, 0] >= 0) & (idx[:, 0] < nx)
          & (idx[:, 1] >= 0) & (idx[:, 1] < ny)
          & (idx[:, 2] >= 0) & (idx[:, 2] < nz))
    cell = idx[:, 1] * nx + idx[:, 0]
    key = torch.where(ok, cell * nz + idx[:, 2],
                      torch.full_like(cell, INVALID_ID))

    order = torch.argsort(key, stable=True)
    skey = key[order]
    spts = points[order]
    sok = ok[order]
    scell = torch.div(skey, nz, rounding_mode="floor")
    sz = skey - scell * nz

    pfirst = _run_starts(scell) & sok
    prow = _cumsum32(pfirst) - 1                                # pillar index
    in_budget = sok & (prow < max_pillars)
    num_pillars = torch.clamp(pfirst.sum().to(I32), max=max_pillars)
    slot = torch.where(in_budget, prow * nz + sz,
                       torch.full_like(prow, max_pillars * nz))
    w = in_budget.to(points.dtype)
    spts = torch.where(in_budget[:, None], spts, 0.0)

    # per-pillar cell id: all points of a pillar share one scell
    pseg = torch.where(in_budget, prow, torch.full_like(prow, max_pillars))
    cells = torch.full((max_pillars + 1,), -1, dtype=I32, device=dev)
    cells = cells.scatter_reduce(0, pseg.long(), scell, "amax")[:-1]

    out = {}
    if feats_mode == "dense":
        payload = torch.cat([spts, w[:, None]], 1)
        agg = segment_sum_sorted(payload, slot, max_pillars * nz + 1)[:-1]
        sums, counts = agg[:, :-1], agg[:, -1]
        out["feats"] = (sums / torch.clamp(counts[:, None], min=1.0)).reshape(
            max_pillars, nz, -1)
        zmask = (counts > 0).reshape(max_pillars, nz)
    elif feats_mode == "stream":
        zmask = torch.zeros(max_pillars * nz + 1, dtype=torch.bool,
                            device=dev)
        zmask[slot.long()] = in_budget
        zmask = zmask[:-1].reshape(max_pillars, nz)
        srow = torch.where(in_budget, torch.div(scell, nx,
                                                rounding_mode="floor"),
                           torch.full_like(scell, ny))
        whist = torch.bincount(srow.long(), minlength=ny + 1)[:ny]
        wstart = torch.cat([whist.new_zeros(1), torch.cumsum(whist, 0)])
        prow_row = torch.where(in_budget & pfirst, srow,
                               torch.full_like(srow, ny))
        phist = torch.bincount(prow_row.long(), minlength=ny + 1)[:ny]
        pstart = (torch.cumsum(phist, 0) - phist).to(I32)
        lane = torch.where(in_budget,
                           prow - pstart[torch.clamp(srow, 0, ny - 1).long()],
                           torch.full_like(prow, INVALID_ID // 2))
        out["stream"] = {
            "payload": torch.cat([spts, w[:, None]], 1),
            "lane": lane.to(I32),
            "z": torch.where(in_budget, sz, torch.full_like(sz, nz)),
            "wstart": wstart.to(I32),
        }
    else:
        raise ValueError(feats_mode)
    mask = _arange(max_pillars, points) < num_pillars
    cells = torch.where(mask, cells, torch.full_like(cells, INVALID_ID))
    coords2d = torch.stack([torch.div(cells, nx, rounding_mode="floor"),
                            cells % nx], 1)
    coords2d = torch.where(mask[:, None], coords2d, 0).to(I32)
    out.update(cells=cells, coords2d=coords2d, mask=mask,
               num_pillars=num_pillars, zmask=zmask)
    return out


# ---------------------------------------------------------------------------
# Row LUT and downsampled pillar sets
# ---------------------------------------------------------------------------

def build_row_lut(cells, mask, bev_hw):
    """Dense (ny*nx,) int32 LUT: cell -> pillar row + 1 (0 = empty)."""
    ny, nx = bev_hw
    safe = torch.where(mask, cells, torch.full_like(cells, ny * nx))
    rows = (_arange(cells.shape[0], cells) + 1) * mask.to(I32)
    lut = torch.zeros(ny * nx + 1, dtype=I32, device=cells.device)
    return lut.scatter_reduce(0, safe.long(), rows, "amax")[:-1]


def _unique_capped_cells(cand, capacity):
    """Sorted unique of an INVALID_ID-padded candidate vector under a static
    budget.  The reference sorts unstably; the result does not depend on
    the order of equal keys."""
    s = torch.sort(cand).values
    real = s != INVALID_ID
    first = _run_starts(s) & real
    seg = _cumsum32(first) - 1
    seg = torch.where(real, torch.clamp(seg, max=capacity),
                      torch.full_like(seg, capacity))
    n = torch.clamp(first.sum().to(I32), max=capacity)
    out = torch.full((capacity + 1,), INVALID_ID, dtype=I32,
                     device=cand.device)
    out = out.scatter_reduce(0, seg.long(), s, "amin")[:capacity]
    mask = _arange(capacity, cand) < n
    return torch.where(mask, out, torch.full_like(out, INVALID_ID)), mask, n


def downsample_pillars(table, in_bev_hw, in_nz, out_capacity, in_lut,
                       site_mode="principal"):
    """Stride-(2,2,2) output pillar set and z occupancy on the LUT route.

    site_mode "principal": out voxel (zo, yo, xo) is occupied iff an
    occupied input voxel has floor-halved coords (zo, yo, xo).  "union":
    spconv's stride-2, padding-1 `SparseConv3d`: occupied iff the 3x3x3
    window around (2zo, 2yo, 2xo) touches an occupied input voxel (the 9
    BEV offsets give 9 candidates a pillar, capped as the reference caps
    them)."""
    ny, nx = in_bev_hw
    ony, onx = -(-ny // 2), -(-nx // 2)
    onz = -(-in_nz // 2)
    cells, mask, zmask = table["cells"], table["mask"], table["zmask"]
    y = torch.div(cells, nx, rounding_mode="floor")
    x = cells % nx
    invalid = torch.full_like(cells, INVALID_ID)
    if site_mode == "principal":
        cand = torch.where(mask, torch.div(y, 2, rounding_mode="floor") * onx
                           + torch.div(x, 2, rounding_mode="floor"), invalid)
    elif site_mode == "union":
        cols = []
        for dy, dx in BEV_OFFSETS:
            ty, tx = y - dy, x - dx
            yo = torch.div(ty, 2, rounding_mode="floor")
            xo = torch.div(tx, 2, rounding_mode="floor")
            inb = ((ty % 2 == 0) & (tx % 2 == 0) & (yo >= 0) & (yo < ony)
                   & (xo >= 0) & (xo < onx) & mask)
            cols.append(torch.where(inb, yo * onx + xo, invalid))
        cand = torch.cat(cols)
    else:
        raise ValueError(f"unknown site_mode {site_mode!r}")
    out_cells, out_mask, n_out = _unique_capped_cells(cand, out_capacity)
    oc2d = torch.stack([torch.div(out_cells, onx, rounding_mode="floor"),
                        out_cells % onx], 1)
    oc2d = torch.where(out_mask[:, None], oc2d, 0).to(I32)

    def in_rows(yy, xx):
        """Input pillar rows at (yy, xx) and whether one is there."""
        inb = (yy >= 0) & (yy < ny) & (xx >= 0) & (xx < nx) & out_mask
        v = in_lut[torch.clamp(yy * nx + xx, 0, ny * nx - 1).long()]
        return torch.clamp(v - 1, min=0).long(), (v > 0) & inb

    zagg = torch.zeros(out_capacity, onz, dtype=torch.bool,
                       device=cells.device)
    if site_mode == "principal":
        # the 4 children pillars, their z pairs OR-reduced
        pad = in_nz + in_nz % 2
        zm = F.pad(zmask, (0, pad - in_nz))
        for cy in (0, 1):
            for cx in (0, 1):
                row, ok = in_rows(2 * oc2d[:, 0] + cy, 2 * oc2d[:, 1] + cx)
                child = zm[row] & ok[:, None]
                zagg |= child.reshape(-1, pad // 2, 2).any(-1)[:, :onz]
    else:
        # any occupied input in the 3-window around (2zo, 2yo, 2xo): the
        # z window read through a one-voxel halo
        zext = F.pad(zmask, (1, 1))
        zo = 2 * torch.arange(onz, device=cells.device)
        for dy, dx in BEV_OFFSETS:
            row, ok = in_rows(2 * oc2d[:, 0] + dy, 2 * oc2d[:, 1] + dx)
            nb = zext[row] & ok[:, None]
            zagg |= nb[:, zo] | nb[:, zo + 1] | nb[:, zo + 2]
    zagg &= out_mask[:, None]
    return {"cells": out_cells, "coords2d": oc2d, "mask": out_mask,
            "num_pillars": n_out, "zmask": zagg,
            "bev_hw": (ony, onx), "nz": onz}


def halve_zmask(zmask, out_nz):
    """Out z occupied iff either child z is occupied."""
    nz = zmask.shape[1]
    zm = F.pad(zmask, (0, nz % 2))
    return zm.reshape(zmask.shape[0], -1, 2).any(-1)[:, :out_nz]


# ---------------------------------------------------------------------------
# The (3,1,1) z-conv on the compact table
# ---------------------------------------------------------------------------

def zconv_matmul(g, w3, z_stride, out_nz):
    """z-window conv as one matmul with N = 3*Cout plus an overlap-add:
    out[z] = sum_t g[z*s + t - 1] @ w3[t] (zero pad).  g (M, nz, K),
    w3 (3, K, Cout)."""
    m, nz, k = g.shape
    cout = w3.shape[2]
    gp = F.pad(g, (0, 0, 1, 1))
    w2 = w3.permute(1, 0, 2).reshape(k, 3 * cout)
    unf = (gp.reshape(-1, k) @ w2).reshape(m, nz + 2, 3, cout)
    span = z_stride * (out_nz - 1) + 1
    out = 0.0
    for t in range(3):
        out = out + unf[:, t:t + span:z_stride, t, :]
    return out


def z_conv(feats, zmask_out, weight, z_stride, out_nz):
    """The final (3,1,1)-kernel z-stride conv: no BEV gather at all."""
    out = zconv_matmul(feats, weight, z_stride, out_nz)
    return torch.where(zmask_out[:, :out.shape[1], None], out, 0.0)


def _near_first_offsets(r):
    """The (2r+1)^3 zyx offsets ordered by L1 norm, ties in meshgrid order."""
    ar = torch.arange(-r, r + 1, dtype=I32)
    offs = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                       -1).reshape(-1, 3)
    return offs[torch.argsort(offs.abs().sum(1), stable=True)]


def voxel_query_pillar(query_coords_zyx, lut, zmask_flat, nz: int, bev_hw,
                       max_range: int = 1, nsample: int = 16):
    """Neighbour voxels of integer zyx coords (M, 3) through the row LUT
    (ny*nx,): the (2r+1)^3 offsets probed nearest first, the first
    `nsample` occupied ones kept.  Returns idx (M, nsample) int32 rows of
    the flat (MP*nz) slot table (0 where nothing was kept) and found
    (M, nsample)."""
    ny, nx = bev_hw
    dev = query_coords_zyx.device
    offs = _near_first_offsets(max_range).to(dev)
    nb = query_coords_zyx.to(I32)[:, None, :] + offs[None]
    inb = ((nb[..., 0] >= 0) & (nb[..., 0] < nz) & (nb[..., 1] >= 0)
           & (nb[..., 1] < ny) & (nb[..., 2] >= 0) & (nb[..., 2] < nx))
    cell = torch.clamp(nb[..., 1] * nx + nb[..., 2], 0, ny * nx - 1)
    v = lut[cell.long()]
    slot = torch.clamp(v - 1, min=0) * nz + torch.clamp(nb[..., 0], 0, nz - 1)
    found = inb & (v > 0) & zmask_flat[slot.long()]
    m, k = found.shape
    if k <= nsample:
        pad = (0, nsample - k)
        return F.pad(slot, pad), F.pad(found, pad)
    rank = torch.cumsum(found.to(I32), 1, dtype=I32) - 1
    take = found & (rank < nsample)
    safe_rank = torch.where(take, rank, torch.full_like(rank, nsample))
    idx = torch.zeros((m, nsample + 1), dtype=I32, device=dev)
    idx = idx.scatter_reduce(1, safe_rank.long(),
                             torch.where(take, slot, torch.zeros_like(slot)),
                             "amax")[:, :nsample]
    fnd = _arange(nsample, idx)[None, :] < torch.clamp(
        found.sum(1), max=nsample)[:, None]
    return idx, fnd


# ---------------------------------------------------------------------------
# Row-padded transposed layout
# ---------------------------------------------------------------------------

def rowpad_layout(cells, mask, bev_hw, row_budget):
    """Both sides of the row-padded mapping: BEV row y owns slots
    [y*B, (y+1)*B), rank = position within the row.

    Returns slot (MP,) compact -> rowpad (ny*B when dropped), keep (MP,),
    gidx (ny, B) rowpad slot -> compact row (clipped), gvalid (ny, B)."""
    ny, nx = bev_hw
    b = row_budget
    mp = cells.shape[0]
    y = torch.where(mask, torch.div(cells, nx, rounding_mode="floor"), 0)
    counts = torch.zeros(ny, dtype=I32, device=cells.device).index_add_(
        0, y.long(), mask.to(I32))
    row_start = _cumsum32(counts) - counts
    rank = _arange(mp, cells) - row_start[y.long()]
    keep = mask & (rank < b)
    slot = torch.where(keep, y * b + rank, torch.full_like(rank, ny * b))
    gidx = torch.clamp(row_start[:, None] + _arange(b, cells)[None, :],
                       0, max(mp - 1, 0))
    gvalid = _arange(b, cells)[None, :] < torch.clamp(counts, max=b)[:, None]
    return {"slot": slot.to(I32), "keep": keep, "gidx": gidx.to(I32),
            "gvalid": gvalid}


def rowpad_gather(values, gidx, gvalid):
    """Compact per-pillar rows (MP, D) -> transposed row-padded (ny, D, B)."""
    got = values[gidx.long()]
    got = torch.where(gvalid[..., None], got, torch.zeros_like(got))
    return got.permute(0, 2, 1).contiguous()


def _from_rowpad(rp, slot, keep, fill):
    ny, d, b = rp.shape
    flat = rp.permute(0, 2, 1).reshape(ny * b, d)
    got = flat[torch.clamp(slot, max=ny * b - 1).long()]
    return torch.where(keep[:, None], got, torch.full_like(got, fill))


class _FromRowpad(torch.autograd.Function):
    """The reference's `from_rowpad_g`: the row-pad map is a bijection
    between kept rows and live slots, so the cotangent of the compact rows
    is `rowpad_gather` of their gradient.  No gradient for the maps."""

    @staticmethod
    def forward(ctx, rp, slot, keep, gidx, gvalid, fill):
        ctx.save_for_backward(gidx, gvalid)
        return _from_rowpad(rp, slot, keep, fill)

    @staticmethod
    def backward(ctx, g):
        global GATHER_VJPS
        GATHER_VJPS += 1
        gidx, gvalid = ctx.saved_tensors
        return (rowpad_gather(g, gidx, gvalid),) + (None,) * 5


def from_rowpad(rp, slot, keep, gidx, gvalid, fill=0.0):
    """Gather the compact per-pillar rows (MP, D) back out of (ny, D, B);
    `gidx`, `gvalid` (the inverse map, `rowpad_layout`) carry the
    gradient back."""
    return _FromRowpad.apply(rp, slot, keep, gidx, gvalid, fill)


def rowpad_xcoords(xcoord, gidx, gvalid):
    """Per-slot x-coordinate table (ny, B) int32, NBR_BIG where empty."""
    return torch.where(gvalid, xcoord.to(I32)[gidx.long()],
                       torch.full_like(gidx, NBR_BIG))


def rowpad_nbr_rank(xq_rp, x_in, mode="subm"):
    """Neighbour-rank tensor (ny_out, NBR_ROWS, B_out) int32 from per-row
    sorted x-coords: the rank of neighbour x' in its target row is the count
    of strictly smaller x-coords there; B_in where the tap is absent.
    mode 'subm' targets (y+dy, x+dx), 'down' (2y+dy, 2x+dx), 'up'
    ((y+dy)/2, (x+dx)/2) when both divide."""
    ny_out, b_out = xq_rp.shape
    ny_in, b_in = x_in.shape
    i = _arange(ny_out, xq_rp)
    qvalid = xq_rp < NBR_BIG
    rows = []
    for j in range(9):
        dy, dx = j // 3 - 1, j % 3 - 1
        if mode == "subm":
            xp, src = xq_rp + dx, i + dy
        elif mode == "down":
            xp, src = 2 * xq_rp + dx, 2 * i + dy
        elif mode == "up":
            num = xq_rp + dx + 2          # >= 1: trunc div == floor div
            xp, src = torch.div(num, 2, rounding_mode="floor") - 1, i + dy
        else:
            raise ValueError(mode)
        if mode == "up":
            half = torch.div(src, 2, rounding_mode="floor")
            rv = (src >= 0) & (src % 2 == 0) & (half < ny_in)
            xt = x_in[torch.clamp(half, 0, ny_in - 1).long()]
        else:
            rv = (src >= 0) & (src < ny_in)
            xt = x_in[torch.clamp(src, 0, ny_in - 1).long()]
        lt = (xt[:, :, None] < xp[:, None, :]).sum(1, dtype=I32)
        fnd = (xt[:, :, None] == xp[:, None, :]).any(1) & qvalid
        if mode == "up":
            fnd &= (num % 2) == 0
        fnd &= rv[:, None]
        rows.append(torch.where(fnd, lt, torch.full_like(lt, b_in)))
    rows += [torch.full_like(rows[0], b_in)] * (NBR_ROWS - 9)
    return torch.stack(rows, 1)


def _densify(feats, cells, mask, bev_hw):
    ny, nx = bev_hw
    safe = torch.where(mask, cells, torch.full_like(cells, ny * nx))
    lut = torch.zeros(ny * nx + 1, dtype=I32, device=feats.device)
    lut = lut.scatter_reduce(0, safe.long(),
                             _arange(feats.shape[0], cells) + 1, "amax")
    padded = torch.cat([feats.new_zeros(1, feats.shape[-1]), feats], 0)
    return padded[lut[:-1].long()].reshape(ny, nx, -1)


class _Densify(torch.autograd.Function):
    """The reference's VJP of `densify_pillars`: live cells are unique, so
    a live pillar's gradient is its cell's row of the map's.  No gradient
    for the cells or the mask."""

    @staticmethod
    def forward(ctx, feats, cells, mask, bev_hw):
        ctx.save_for_backward(cells, mask)
        ctx.bev_hw = bev_hw
        return _densify(feats, cells, mask, bev_hw)

    @staticmethod
    def backward(ctx, g):
        global GATHER_VJPS
        GATHER_VJPS += 1
        cells, mask = ctx.saved_tensors
        ny, nx = ctx.bev_hw
        got = g.reshape(ny * nx, -1)[torch.where(mask, cells, 0).long()]
        return (torch.where(mask[:, None], got, torch.zeros_like(got)),
                None, None, None)


def densify_pillars(feats, cells, mask, bev_hw):
    """(MP, D) pillar features -> dense (ny, nx, D) BEV map.  Live pillars
    have unique cells (the pillar table guarantees it)."""
    return _Densify.apply(feats, cells, mask, bev_hw)

"""Pillar plan for all stride levels (port of `build_pillar_plan`,
`_downsample_centroids_pillar` and `plan_grids` from the reference's
backbone3d_pillar.py / backbone3d.py), as the row-padded backbone runs it:
row LUTs, downsampling in either site mode, no gather maps; with a second
stage also the per-voxel point centroids of every level."""

from __future__ import annotations

from typing import Sequence

import torch

from detzero_tpu_torch.ops import pillars


def plan_grids(grid_zyx):
    """Static per-level grids: strides 1/2/4/8 plus the final z-halved grid."""
    grids = [tuple(grid_zyx)]
    g = grid_zyx
    for _ in range(3):
        g = tuple(-(-d // 2) for d in g)
        grids.append(g)
    grids.append((-(-g[0] // 2), g[1], g[2]))
    return grids


def lossless_row_budget(grid_zyx) -> int:
    """The row budget at which no BEV row of any level drops a pillar: the
    L0 row width nx.  A row of level l holds at most its own nx_l pillars,
    and each level's nx is its parent's halved, rounded up, so L0's bounds
    them all; the check below holds every level to it."""
    grids = plan_grids(grid_zyx)
    budget = int(grids[0][2])
    if any(nx > budget for _, _, nx in grids):
        raise ValueError(f"a level of {grids} is wider than L0's {budget} "
                         f"columns")
    return budget


def build_pillar_plan(table, grid_zyx, capacities: Sequence[int],
                      site_mode: str = "principal",
                      with_centroids: bool = False):
    """table: `pillars.build_pillar_table` output at stride 1 (dense mode
    when `with_centroids`); capacities: pillar budgets per level;
    site_mode: the downsampled sites (`pillars.downsample_pillars`).  The
    centroids go to principal sites in either mode, as the reference's do.
    Returns 5 level dicts (cells, coords2d,
    mask, zmask, and for levels 0..3 the row LUT `lut` and, with
    `with_centroids`, `centroids` (MP, nz, 3): level 0's are the voxels'
    point means, the xyz columns of the dense table)."""
    grids = plan_grids(grid_zyx)
    levels = []
    keys = ("cells", "coords2d", "mask", "zmask")
    cur = {k: table[k] for k in keys}
    if with_centroids:
        cur["centroids"] = table["feats"][..., :3]
    lut = pillars.build_row_lut(cur["cells"], cur["mask"], grids[0][1:])
    for lvl in range(4):
        nz, ny, nx = grids[lvl]
        levels.append(dict(cur, lut=lut))
        if lvl < 3:
            onz, ony, onx = grids[lvl + 1]
            nxt = pillars.downsample_pillars(
                cur, (ny, nx), nz, capacities[lvl + 1], in_lut=lut,
                site_mode=site_mode)
            out_lut = pillars.build_row_lut(nxt["cells"], nxt["mask"],
                                            (ony, onx))
            nxt_cur = {k: nxt[k] for k in keys}
            if with_centroids:
                nxt_cur["centroids"] = _downsample_centroids_pillar(
                    cur, nxt, (ny, nx), out_lut, onz)
            cur, lut = nxt_cur, out_lut
    levels.append({
        "cells": cur["cells"], "coords2d": cur["coords2d"],
        "mask": cur["mask"],
        "zmask": pillars.halve_zmask(cur["zmask"], grids[4][0]),
    })
    return levels


def _downsample_centroids_pillar(cur, nxt, in_bev_hw, out_lut, out_nz):
    """Mean point centroid of each downsampled voxel: every occupied input
    voxel adds its centroid to its principal output site (z // 2, the
    output pillar of its cell; under 'union' that site exists unless the
    level's capacity dropped it, and then the voxel adds nothing).  The
    sums run in float64 over the voxels sorted by output pillar
    (`pillars.segment_sum_sorted`), so they do not depend on the device's
    scatter order."""
    ny, nx = in_bev_hw
    onx = -(-nx // 2)
    ony = -(-ny // 2)
    y, x = cur["coords2d"][:, 0], cur["coords2d"][:, 1]
    ocell = torch.div(y, 2, rounding_mode="floor") * onx \
        + torch.div(x, 2, rounding_mode="floor")
    v = out_lut[torch.clamp(ocell, 0, ony * onx - 1).long()]
    ok = (v > 0) & cur["mask"]
    zmask, centroids = cur["zmask"], cur["centroids"]
    nz = zmask.shape[1]
    pad = nz + nz % 2
    w = torch.nn.functional.pad(zmask, (0, pad - nz)).to(centroids.dtype)
    c = torch.nn.functional.pad(centroids, (0, 0, 0, pad - nz))
    csum = (c * w[..., None]).reshape(c.shape[0], pad // 2, 2, 3).sum(2)
    wsum = w.reshape(w.shape[0], pad // 2, 2).sum(2)
    vals = torch.cat([csum[:, :out_nz].reshape(-1, out_nz * 3),
                      wsum[:, :out_nz]], 1)
    vals = torch.where(ok[:, None], vals, 0.0)
    mp_out = nxt["cells"].shape[0]
    seg = torch.where(ok, v - 1, torch.full_like(v, mp_out))
    order = torch.argsort(seg, stable=True)
    agg = pillars.segment_sum_sorted(vals[order], seg[order], mp_out + 1)
    num = agg[:mp_out, :out_nz * 3].reshape(mp_out, out_nz, 3)
    den = agg[:mp_out, out_nz * 3:]
    return num / torch.clamp(den[..., None], min=1.0)

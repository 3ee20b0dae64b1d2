"""Pillar plan for all stride levels (port of `build_pillar_plan` and
`plan_grids` from the reference's backbone3d_pillar.py / backbone3d.py),
as the inference path runs it: row LUTs, principal-site downsampling, no
gather maps, no centroids."""

from __future__ import annotations

from typing import Sequence

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


def build_pillar_plan(table, grid_zyx, capacities: Sequence[int]):
    """table: `pillars.build_pillar_table` output at stride 1; capacities:
    pillar budgets per level; principal-site downsampling.  Returns 5 level
    dicts (cells, coords2d, mask, zmask, and for levels 0..3 the row LUT
    `lut`)."""
    grids = plan_grids(grid_zyx)
    levels = []
    keys = ("cells", "coords2d", "mask", "zmask")
    cur = {k: table[k] for k in keys}
    for lvl in range(4):
        nz, ny, nx = grids[lvl]
        lut = pillars.build_row_lut(cur["cells"], cur["mask"], (ny, nx))
        levels.append(dict(cur, lut=lut))
        if lvl < 3:
            nxt = pillars.downsample_pillars(
                cur, (ny, nx), nz, capacities[lvl + 1], in_lut=lut)
            cur = {k: nxt[k] for k in keys}
    levels.append({
        "cells": cur["cells"], "coords2d": cur["coords2d"],
        "mask": cur["mask"],
        "zmask": pillars.halve_zmask(cur["zmask"], grids[4][0]),
    })
    return levels

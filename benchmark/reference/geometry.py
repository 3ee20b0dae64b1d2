"""The sparse 3D backbone's voxel sites, worked out from the points alone.

The semantics are the configuration's (`VOXEL_CAPACITIES`, the 128-pillar
row budget of `BACKBONE3D: pillar_pallas`, principal downsampled sites):

* a pillar is an occupied BEV cell (y, x) of a level; its z column holds the
  occupied voxels of that cell;
* level 0 keeps the `capacities[0]` pillars of lowest cell id y * nx + x,
  and only the points inside them;
* level l + 1's pillars are the cells (y // 2, x // 2) of level l's kept
  pillars, again the `capacities[l + 1]` of lowest id; its voxel (z // 2)
  is occupied where a child voxel is;
* the convolutions see only the pillars that rank below the row budget in
  their BEV row (x ascending); the others hold no features, but they still
  make the next level's sites;
* the last level's z column is halved once more for the final (3, 1, 1)
  convolution, over every pillar of level 3.

Neighbours are found by hashing: a voxel's key is (y * nx + x) * nz + z,
and a tap's neighbour is looked up in the sorted keys of the input sites
(`torch.searchsorted`).  Nothing here knows of row-padded tables or
neighbour-rank maps.
"""

from __future__ import annotations

import torch


def grid_of(pc_range, voxel_size):
    """(nz, ny, nx) of the voxel grid."""
    nx = round((pc_range[3] - pc_range[0]) / voxel_size[0])
    ny = round((pc_range[4] - pc_range[1]) / voxel_size[1])
    nz = round((pc_range[5] - pc_range[2]) / voxel_size[2])
    return nz, ny, nx


def level_grids(grid):
    """Levels 0-3 (each dimension halved, rounded up) and the final grid
    (level 3's z halved once more)."""
    out = [tuple(grid)]
    for _ in range(3):
        out.append(tuple(-(-d // 2) for d in out[-1]))
    nz, ny, nx = out[-1]
    out.append((-(-nz // 2), ny, nx))
    return out


def _row_keep(cells, nx, row_budget):
    """True for the pillars that rank below `row_budget` in their row."""
    y = torch.div(cells, nx, rounding_mode="floor")
    first = torch.searchsorted(y, y, side="left")
    rank = torch.arange(cells.shape[0], device=cells.device) - first
    return rank < row_budget


def _halve_z(zmask, out_nz):
    """Voxel z // 2 occupied where z is: (n, nz) -> (n, out_nz)."""
    n, nz = zmask.shape
    pad = torch.zeros((n, 2 * out_nz - nz), dtype=torch.bool,
                      device=zmask.device)
    return torch.cat([zmask, pad], 1).reshape(n, out_nz, 2).any(-1)


class Level:
    """One level's pillars: cells (n,) sorted int64, zmask (n, nz), keep
    (n,) the row budget's verdict, grid (nz, ny, nx).  Its conv sites are
    the occupied voxels of kept pillars, in key order."""

    def __init__(self, cells, zmask, grid, row_budget):
        self.cells, self.zmask, self.grid = cells, zmask, tuple(grid)
        self.keep = _row_keep(cells, grid[2], row_budget)
        p, z = torch.nonzero(zmask & self.keep[:, None], as_tuple=True)
        self.site_pillar, self.site_z = p, z
        self.keys = cells[p] * grid[0] + z            # ascending

    @property
    def n_sites(self):
        return int(self.keys.shape[0])

    def site_yxz(self):
        nx = self.grid[2]
        c = self.cells[self.site_pillar]
        return (torch.div(c, nx, rounding_mode="floor"), c % nx,
                self.site_z)


def voxelize(points, valid, grid, voxel_size, pc_range, capacity):
    """Points (P, F) f32 -> (level-0 cells (n,), zmask (n, nz), voxel keys
    (V,) sorted, voxel means (V, F) f32 of every column).  The voxel index is
    floor((p - lo) / size) in float32, as a loader would compute it."""
    nz, ny, nx = grid
    dev = points.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    idx = torch.floor((points[:, :3] - lo) / vs).long()
    ok = (valid & (idx[:, 0] >= 0) & (idx[:, 0] < nx) & (idx[:, 1] >= 0)
          & (idx[:, 1] < ny) & (idx[:, 2] >= 0) & (idx[:, 2] < nz))
    cell = idx[:, 1] * nx + idx[:, 0]
    cells = torch.unique(cell[ok])[:capacity]
    pos = torch.searchsorted(cells, cell).clamp(max=max(len(cells) - 1, 0))
    inside = ok & (cells[pos] == cell) if len(cells) else ok & False
    key = cell * nz + idx[:, 2]
    vkeys, inv = torch.unique(key[inside], return_inverse=True)
    pts = points[inside].double()
    sums = torch.zeros((len(vkeys), points.shape[1]), dtype=torch.float64,
                       device=dev).index_add_(0, inv, pts)
    cnt = torch.zeros(len(vkeys), dtype=torch.float64,
                      device=dev).index_add_(0, inv, torch.ones_like(
                          pts[:, 0]))
    means = (sums / cnt[:, None]).float()
    vcell = torch.div(vkeys, nz, rounding_mode="floor")
    zmask = torch.zeros((len(cells), nz), dtype=torch.bool, device=dev)
    zmask[torch.searchsorted(cells, vcell), vkeys % nz] = True
    return cells, zmask, vkeys, means


def downsample(level, out_grid, capacity):
    """The next level's (cells, zmask): principal sites (y // 2, x // 2,
    z // 2) of every pillar of `level`, kept by the row budget or not."""
    nz, ny, nx = level.grid
    onz, ony, onx = out_grid
    y = torch.div(level.cells, nx, rounding_mode="floor")
    x = level.cells % nx
    parent = torch.div(y, 2, rounding_mode="floor") * onx \
        + torch.div(x, 2, rounding_mode="floor")
    cells = torch.unique(parent)[:capacity]
    pos = torch.searchsorted(cells, parent).clamp(max=max(len(cells) - 1, 0))
    hit = cells[pos] == parent if len(cells) else parent < 0
    zm = torch.zeros((len(cells), onz), dtype=torch.int32,
                     device=level.cells.device)
    half = _halve_z(level.zmask, onz).int()
    zm.index_add_(0, pos[hit], half[hit])
    return cells, zm > 0


def build_levels(points, valid, cfg):
    """Levels 0-3 of one frame and the final (cells, zmask), plus level 0's
    voxel means at its conv sites (the stem's input)."""
    grids = level_grids(cfg["grid"])
    caps, budget = cfg["capacities"], cfg["row_budget"]
    cells, zmask, vkeys, means = voxelize(
        points, valid, grids[0], cfg["voxel_size"], cfg["pc_range"],
        caps[0])
    levels = [Level(cells, zmask, grids[0], budget)]
    for lvl in range(1, 4):
        cells, zmask = downsample(levels[-1], grids[lvl], caps[lvl])
        levels.append(Level(cells, zmask, grids[lvl], budget))
    l3 = levels[3]
    final_zmask = _halve_z(l3.zmask, grids[4][0])
    # the stem reads the means of the voxels at level 0's sites
    pos = torch.searchsorted(vkeys, levels[0].keys)
    stem_in = means[pos]
    return levels, final_zmask, stem_in


def neighbours(out_level, in_level, mode):
    """(V_out, 27) int64 index into in_level's sites, V_in where the tap has
    no site.  Tap k = ((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1) reads the
    input voxel (y + dy, x + dx, z + dz) ('subm') or (2y + dy, 2x + dx,
    2z + dz) ('down')."""
    y, x, z = out_level.site_yxz()
    nz, ny, nx = in_level.grid
    s = 1 if mode == "subm" else 2
    dev = y.device
    d = torch.arange(-1, 2, device=dev)
    dz, dy, dx = torch.meshgrid(d, d, d, indexing="ij")
    ty = s * y[:, None] + dy.reshape(1, -1)
    tx = s * x[:, None] + dx.reshape(1, -1)
    tz = s * z[:, None] + dz.reshape(1, -1)
    inb = ((ty >= 0) & (ty < ny) & (tx >= 0) & (tx < nx) & (tz >= 0)
           & (tz < nz))
    key = (ty * nx + tx) * nz + tz
    keys = in_level.keys
    n_in = keys.shape[0]
    if n_in == 0:
        return torch.full_like(key, 0)
    pos = torch.searchsorted(keys, key).clamp(max=n_in - 1)
    found = inb & (keys[pos] == key)
    return torch.where(found, pos, torch.full_like(pos, n_in))

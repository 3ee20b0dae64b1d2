"""The work counts against hand counts on a tiny grid."""

import itertools

import pytest
import torch

from benchmark import work
from benchmark.reference import geometry


def level(voxels, grid, budget=128):
    """A Level from (y, x, z) voxels."""
    nz, ny, nx = grid
    cells = sorted({y * nx + x for y, x, _ in voxels})
    zmask = torch.zeros(len(cells), nz, dtype=torch.bool)
    for y, x, z in voxels:
        zmask[cells.index(y * nx + x), z] = True
    return geometry.Level(torch.tensor(cells), zmask, grid, budget)


def brute_pairs(out_vox, in_vox, stride):
    n = 0
    for (y, x, z), (dy, dx, dz) in itertools.product(
            out_vox, itertools.product((-1, 0, 1), repeat=3)):
        n += (stride * y + dy, stride * x + dx, stride * z + dz) in in_vox
    return n


def test_subm_pairs_by_hand():
    # two voxels side by side in x, one above the first: each sees itself
    # and its neighbours -> 3 + 2 + 2 + (the two diagonals) ...
    vox = [(1, 1, 1), (1, 2, 1), (1, 1, 2)]
    lv = level(vox, (4, 4, 4))
    got = work._pairs(lv, lv, "subm")
    # (1,1,1) sees all 3; (1,2,1) sees itself, (1,1,1), (1,1,2) (diagonal);
    # (1,1,2) sees all 3
    assert got == {"pairs": 9, "n_read": 3, "n_out": 3}
    assert got["pairs"] == brute_pairs(vox, set(vox), 1)


def test_down_pairs_by_hand():
    fine = [(2, 2, 2), (3, 3, 3), (0, 0, 0)]
    lv0 = level(fine, (4, 4, 4))
    cells, zmask = geometry.downsample(lv0, (2, 2, 2), 10)
    lv1 = geometry.Level(cells, zmask, (2, 2, 2), 128)
    out_vox = {(int(c) // 2, int(c) % 2, int(z))
               for c, row in zip(cells, zmask) for z in range(2) if row[z]}
    assert out_vox == {(1, 1, 1), (0, 0, 0)}
    got = work._pairs(lv1, lv0, "down")
    # out (1,1,1) reads inputs (1..3)^3: (2,2,2) and (3,3,3); out (0,0,0)
    # reads (-1..1)^3: (0,0,0)
    assert got["pairs"] == 3 == brute_pairs(out_vox, set(fine), 2)
    assert got["n_read"] == 3 and got["n_out"] == 2


def test_row_budget_drops_sites():
    vox = [(0, x, 0) for x in range(6)]
    lv = level(vox, (2, 2, 8), budget=4)
    assert lv.n_sites == 4
    assert work._pairs(lv, lv, "subm")["pairs"] == 4 + 2 * 3


def test_capacity_keeps_lowest_cells():
    pts = torch.tensor([[0.05, 0.05, 0.05, 0, 0, 0],
                        [0.35, 0.05, 0.05, 0, 0, 0],
                        [0.05, 0.25, 0.05, 0, 0, 0]])
    cells, zmask, keys, means = geometry.voxelize(
        pts, torch.ones(3, dtype=torch.bool), (4, 4, 4), (0.1, 0.1, 0.1),
        (0, 0, 0, 0.4, 0.4, 0.4), 2)
    assert cells.tolist() == [0, 3]           # cell 2 * 4 + 0 is dropped
    assert keys.shape[0] == 2 and zmask.sum() == 2


def test_bound_and_flops_by_hand():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)
    conv = dict(name="c", cin=2, cout=3, pairs=5, n_read=4, n_out=7,
                residual=True)
    w = {"convs": [conv], "zconv_pairs": 0, "dense_flops": 0.0}
    n_bytes = 2 * 4 * 2 + 2 * 27 * 2 * 3 + 2 * 7 * 3 + 8 * 3 + 2 * 7 * 3
    assert work.k2_bound([w]) == pytest.approx(n_bytes / 3.35e12)
    assert work.flops(w, False) == 2 * 2 * 3 * 5
    assert work.flops(w, True) == 2 * (2 * 2 * 3 * 5)   # the stem's input
    # two frames of one launch add their counts before the bound
    assert work.k5_bound([w, w]) == pytest.approx(
        (2 * 8 * 2 + 2 * 14 * 3 + 4 * 27 * 2 * 3) / 3.35e12)


def test_dense_flops_by_hand():
    cfg = {"grid": (8, 16, 16), "bev_hw": (2, 2), "bev_layer_nums": (0, 0),
           "class_ids_each_head": [(0,)]}
    # final nz 1: the BEV map has 128 channels
    want = (2 * 128 * 128 * 9 * 4 + 2 * 128 * 256 * 4      # level 0
            + 2 * 128 * 256 * 9 * 1 + 2 * 256 * 256 * 4 * 1   # level 1
            + 2 * 512 * 64 * 9 * 4 + 7 * 2 * 64 * 64 * 9 * 4
            + 2 * 64 * 12 * 9 * 4)
    assert work.dense_flops(cfg) == want

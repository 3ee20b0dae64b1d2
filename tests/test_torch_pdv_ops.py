"""The PDV second stage's operations in detzero_tpu_torch against
detzero_tpu on the CPU: kernel K7's plain version (the N x M rotated BEV
overlap) and the 3D IoU around it, the plan's centroids and row LUTs, the
voxel query, and the box geometry and losses.  Each test states its
tolerance.  tests/test_torch_pdv_head.py holds the RoI head's."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.models.detection import pdv_head as jpdv
from detzero_tpu.models.detection.backbone3d_pillar import (
    build_pillar_plan as jax_plan,
)
from detzero_tpu.ops import box_ops as jbo
from detzero_tpu.ops import iou3d as jiou3d
from detzero_tpu.ops import losses as jl
from detzero_tpu.ops import pallas_iou
from detzero_tpu.ops import pillars as jp
from detzero_tpu_torch.models.detection import pdv_head
from detzero_tpu_torch.models.detection.backbone3d_pillar import (
    build_pillar_plan,
)
from detzero_tpu_torch.ops import box_ops, iou3d, iou_bev, losses
from detzero_tpu_torch.ops import pillars as tp

torch.set_num_threads(1)

GRID = (8, 64, 64)
VS = (0.2, 0.2, 0.5)
PCR = (-6.4, -6.4, -2.0, 6.4, 6.4, 2.0)
CAPS = (512, 256, 128, 64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes7(seed, n, extent=8.0):
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-extent, extent, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-math.pi, math.pi, n)
    return b


def _overlap_sets(n, m, seed):
    """A (n, 5) and B (m, 5) BEV boxes: B's first rows are A's first rows
    unchanged (identical), shrunk inside them (nested), rotated by 45 and
    90 degrees and shifted far away (disjoint); the rest jittered copies of
    A's boxes and random boxes."""
    rng = np.random.RandomState(seed)
    a = _boxes7(seed, n)[:, [0, 1, 3, 4, 6]]
    k = min(n, 8)
    special = [a[:k].copy() for _ in range(5)]
    special[1][:, 2:4] *= 0.5
    special[2][:, 4] += math.pi / 4
    special[3][:, 4] += math.pi / 2
    special[4][:, :2] += 40.0
    rest = m - 5 * k
    jit = a[rng.randint(0, n, rest // 2)] + rng.randn(rest // 2, 5).astype(
        np.float32) * np.float32([0.4, 0.4, 0.2, 0.2, 0.2])
    jit[:, 2:4] = np.abs(jit[:, 2:4]) + 0.1
    rand = _boxes7(seed + 1, rest - rest // 2)[:, [0, 1, 3, 4, 6]]
    return a, np.concatenate(special + [jit, rand]).astype(np.float32)


# ---------------------------------------------------------------- K7

@pytest.mark.parametrize("n,m", [(128, 500), (37, 61)])
def test_overlap_bev_plain_parity(n, m):
    """K7's plain version against the Pallas kernel (interpret mode) and
    the reference's XLA clip at the path's shape (128 x 500) and a ragged
    one.  The Pallas kernel and the plain version round alike (1e-5
    absolute, a few float32 ulps of areas up to 25 m^2); the XLA clip walks
    the polygon in another order (1e-4 absolute)."""
    a, b = _overlap_sets(n, m, seed=n)
    got = iou_bev.boxes_overlap_bev_plain(_t(a), _t(b)).numpy()
    ref_pallas = np.asarray(pallas_iou.boxes_overlap_bev(jnp.asarray(a),
                                                         jnp.asarray(b)))
    ref_xla = np.asarray(jiou3d.boxes_overlap_bev(jnp.asarray(a),
                                                  jnp.asarray(b)))
    assert got.shape == ref_pallas.shape == (n, m)
    assert np.abs(got - ref_pallas).max() <= 1e-5
    assert np.abs(got - ref_xla).max() <= 1e-4
    area = a[:8, 2] * a[:8, 3]
    diag = np.arange(8)
    assert np.abs(got[diag, diag] - area).max() <= 1e-5 * area.max()
    assert np.abs(got[diag, diag + 8] - area / 4).max() <= 1e-5 * area.max()
    assert (got[diag, diag + 16] > 0).all() and (got[diag, diag + 24] > 0).all()
    assert (got[diag, diag + 32] == 0).all()
    assert (got > 0).sum() > 2 * m
    # the wrapper takes the plain version on CPU tensors, launching nothing
    n0 = iou_bev.OVERLAP_LAUNCHES
    assert np.array_equal(iou_bev.boxes_overlap_bev(_t(a), _t(b)).numpy(),
                          got)
    assert iou_bev.OVERLAP_LAUNCHES == n0


def test_boxes_iou3d_parity():
    """boxes_iou3d (K7 plus heights and volumes in torch) against the
    reference's: 1e-5 absolute on IoU in [0, 1]."""
    a = _boxes7(3, 40)
    b = np.concatenate([a[:10] + 0.1, _boxes7(4, 30)])
    ref = np.asarray(jiou3d.boxes_iou3d(jnp.asarray(a), jnp.asarray(b)))
    got = iou3d.boxes_iou3d(_t(a), _t(b)).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    assert (got[np.arange(10), np.arange(10)] > 0.5).all()


# ---------------------------------------------------------------- plan

def cloud_plans():
    """The reference's and the port's pillar plans of one cloud with
    centroids (dense table, 2048 points against a 512-pillar budget)."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-6, 6, (2048, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.8, 1.8, 2048)
    valid = rng.rand(2048) > 0.05
    jt = jp.build_pillar_table(jnp.asarray(pts), jnp.asarray(valid), GRID,
                               VS, PCR, 512)
    jplan = jax.jit(lambda tb: jax_plan(tb, GRID, CAPS, with_centroids=True,
                                        with_gather_maps=False))(jt)
    tt = tp.build_pillar_table(_t(pts), _t(valid), GRID, VS, PCR, 512)
    return jplan, build_pillar_plan(tt, GRID, CAPS, with_centroids=True)


@pytest.fixture(scope="module")
def plans():
    return cloud_plans()


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_plan_luts_and_centroids(plans, lvl):
    """Row LUTs bit-exact; centroids within 1e-6 * max|ref| (the reference
    sums in float32 by scatter, the port in float64 in sorted order)."""
    jplan, tplan = plans
    assert np.array_equal(np.asarray(jplan[lvl]["lut"]),
                          tplan[lvl]["lut"].numpy())
    ref = np.asarray(jplan[lvl]["centroids"])
    got = tplan[lvl]["centroids"].numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(ref).max() > 1.0


@pytest.mark.parametrize("lvl", [2, 3])
def test_voxel_query_pillar_exact(plans, lvl):
    """idx and found bit-exact on integer queries that cover the grid and
    step past its edges."""
    jplan, _ = plans
    grids = [(8, 64, 64), (4, 32, 32), (2, 16, 16), (1, 8, 8)]
    nz, ny, nx = grids[lvl]
    rng = np.random.RandomState(lvl)
    q = np.stack([rng.randint(-1, nz + 1, 3000), rng.randint(-1, ny + 1, 3000),
                  rng.randint(-1, nx + 1, 3000)], 1).astype(np.int32)
    lut = np.asarray(jplan[lvl]["lut"])
    zm = np.asarray(jplan[lvl]["zmask"]).reshape(-1)
    ji, jf = jp.voxel_query_pillar(jnp.asarray(q), jnp.asarray(lut),
                                   jnp.asarray(zm), nz, (ny, nx))
    ti, tf = tp.voxel_query_pillar(_t(q), _t(lut), _t(zm), nz, (ny, nx))
    assert ti.dtype == torch.int32
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert 0 < int(tf.sum()) < tf.numel()


# ---------------------------------------------------------------- geometry

def test_box_geometry_parity():
    """Rotation, 3D corners, BEV keypoints, RoI grid points and bilinear
    BEV samples: 1e-5 * max(|ref|, 1)."""
    boxes = _boxes7(5, 20)
    jb, tb = jnp.asarray(boxes), _t(boxes)

    def close(ref, got):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() \
            <= 1e-5 * max(np.abs(ref).max(), 1.0)

    pts = np.random.RandomState(6).randn(20, 9, 4).astype(np.float32)
    close(jbo.rotate_points_along_z(jnp.asarray(pts), jb[:, 6]),
          box_ops.rotate_points_along_z(_t(pts), tb[:, 6]))
    close(jbo.boxes_to_corners_3d(jb), box_ops.boxes_to_corners_3d(tb))
    close(jbo.box_keypoints_bev(jb), box_ops.box_keypoints_bev(tb))
    close(jpdv.roi_grid_points(jb, 3), pdv_head.roi_grid_points(tb, 3))
    bev = np.random.RandomState(7).randn(8, 8, 6).astype(np.float32)
    xy = np.random.RandomState(8).uniform(-7, 7, (50, 2)).astype(np.float32)
    close(jbo.bilinear_sample_bev(jnp.asarray(bev), jnp.asarray(xy), VS, PCR,
                                  8),
          box_ops.bilinear_sample_bev(_t(bev), _t(xy), VS, PCR, 8))


def test_losses_parity():
    """Smooth-L1 and the corner loss (with and without a mask) and their
    gradients: 1e-5 relative."""
    rng = np.random.RandomState(9)
    pred = _boxes7(10, 30)
    gt = pred + rng.randn(30, 7).astype(np.float32) * 0.3
    mask = rng.rand(30) > 0.3
    a = np.asarray(jl.weighted_smooth_l1(jnp.asarray(pred), jnp.asarray(gt)))
    b = losses.weighted_smooth_l1(_t(pred), _t(gt)).numpy()
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        ref, ref_g = jax.value_and_grad(
            lambda p: jl.corner_loss_lidar(p, jnp.asarray(gt), jm))(
            jnp.asarray(pred))
        p = _t(pred).requires_grad_()
        got = losses.corner_loss_lidar(p, _t(gt), None if m is None
                                       else _t(m))
        got.backward()
        assert abs(float(got.detach()) - float(ref)) \
            <= 1e-5 * abs(float(ref))
        assert np.abs(p.grad.numpy() - np.asarray(ref_g)).max() \
            <= 1e-5 * np.abs(np.asarray(ref_g)).max()

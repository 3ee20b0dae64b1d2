"""Rotated-box overlap, IoU and GIoU (port of `detzero_tpu/ops/iou3d.py`):
the N x M 3D IoU `boxes_iou3d`, which the PDV head's RoI targets take, the
matched pairs `boxes_iou3d_pairwise`, the target of the center head's IoU
branch, the BEV IoU `boxes_iou_bev`, the GIoU `boxes_giou3d` with the
union hull `boxes_union_hull_bev`, and the axis-aligned IoUs.  The BEV
overlaps are kernel K7 (`ops/iou_bev.boxes_overlap_bev`, re-exported here
as the reference's module exports its dispatch) and kernel K6
(`ops/iou_bev.boxes_overlap_bev_pairwise`); the BEV IoU is kernel K3,
whose epilogue computes the reference's ov / max(a + b - ov, 1e-6) with
each operation rounded on its own, so it equals that formula on K7's
overlap.  The hull, heights and volumes are torch ops around them, as the
reference computes them in jnp."""

from __future__ import annotations

import math

import torch

from detzero_tpu_torch.ops.box_ops import (
    boxes3d_to_bev, boxes_to_corners_bev, limit_period,
)
from detzero_tpu_torch.ops.iou_bev import (  # noqa: F401 (re-exported)
    boxes_iou_bev, boxes_overlap_bev, boxes_overlap_bev_pairwise,
)

# pairs a chunk of the union hull (its (pairs, 8, 8) turn tests)
_HULL_CHUNK = 1 << 17


def _z_range(boxes):
    return boxes[:, 2] - boxes[:, 5] / 2, boxes[:, 2] + boxes[:, 5] / 2


def _height_overlap(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) overlap of the z extents."""
    amin, amax = _z_range(boxes_a)
    bmin, bmax = _z_range(boxes_b)
    return torch.clamp(torch.minimum(amax[:, None], bmax[None, :])
                       - torch.maximum(amin[:, None], bmin[None, :]), min=0.0)


def boxes_iou3d(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) 3D IoU (one launch of kernel K7)."""
    ov3d = boxes_overlap_bev(boxes3d_to_bev(boxes_a),
                             boxes3d_to_bev(boxes_b)) \
        * _height_overlap(boxes_a, boxes_b)
    vol_a = torch.prod(boxes_a[:, 3:6], 1)[:, None]
    vol_b = torch.prod(boxes_b[:, 3:6], 1)[None, :]
    return ov3d / torch.clamp(vol_a + vol_b - ov3d, min=1e-6)


def boxes_iou3d_pairwise(boxes_a, boxes_b):
    """(N, 7) x (N, 7) -> (N,) 3D IoU of pair i = (boxes_a[i], boxes_b[i])."""
    ov_bev = boxes_overlap_bev_pairwise(boxes3d_to_bev(boxes_a),
                                        boxes3d_to_bev(boxes_b))
    amin, amax = _z_range(boxes_a)
    bmin, bmax = _z_range(boxes_b)
    ov_h = torch.clamp(torch.minimum(amax, bmax) - torch.maximum(amin, bmin),
                       min=0.0)
    ov3d = ov_bev * ov_h
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return ov3d / torch.clamp(vol_a + vol_b - ov3d, min=1e-6)


def _union_hull_area(pts):
    """(K, 8, 2) point sets -> (K,) convex hull areas by the reference's
    8-step Jarvis march (`iou3d._pair_union_hull_bev`): start at the
    lowest y, then lowest x, then the first such point; the next vertex is
    the farthest distinct point that no other distinct point lies left of
    (scale-free turn test on unit directions, 1e-5); a step without one,
    or back at the start, ends the walk; the area is the fan from the
    start."""
    k = pts.shape[0]
    rows = torch.arange(k, device=pts.device)
    y, x = pts[..., 1], pts[..., 0]
    low = y == y.min(1, keepdim=True).values
    xl = torch.where(low, x, torch.full_like(x, math.inf))
    start = (low & (xl == xl.min(1, keepdim=True).values)).int().argmax(1)
    s_pt = pts[rows, start]
    cur = start
    done = torch.zeros(k, dtype=torch.bool, device=pts.device)
    area = torch.zeros(k, dtype=pts.dtype, device=pts.device)
    for _ in range(8):
        cur_pt = pts[rows, cur]
        v = pts - cur_pt[:, None]
        dist2 = (v * v).sum(-1)
        nv = v / torch.sqrt(dist2 + 1e-20)[..., None]
        cross = nv[:, :, None, 0] * nv[:, None, :, 1] \
            - nv[:, :, None, 1] * nv[:, None, :, 0]
        distinct = dist2 > 1e-12
        right_of_all = (~distinct[:, None, :] | (cross <= 1e-5)).all(2)
        cand = right_of_all & distinct
        nxt = torch.where(cand, dist2, torch.full_like(dist2, -1.0)).argmax(1)
        any_cand = cand.any(1)
        nxt_pt = pts[rows, nxt]
        contrib = ((cur_pt[:, 0] - s_pt[:, 0]) * (nxt_pt[:, 1] - s_pt[:, 1])
                   - (nxt_pt[:, 0] - s_pt[:, 0])
                   * (cur_pt[:, 1] - s_pt[:, 1])) / 2.0
        area = area + torch.where(done | ~any_cand,
                                  torch.zeros_like(contrib), contrib)
        new_done = done | (nxt == start) | ~any_cand
        cur = torch.where(done, cur, nxt)
        done = new_done
    return torch.abs(area)


def boxes_union_hull_bev(boxes_a, boxes_b):
    """(N, 5) x (M, 5) -> (N, M) areas of the convex hull of each pair's 8
    BEV corners (plain torch on the boxes' device, in chunks of pairs)."""
    ca = boxes_to_corners_bev(boxes_a[:, :5])
    cb = boxes_to_corners_bev(boxes_b[:, :5])
    n, m = ca.shape[0], cb.shape[0]
    out = torch.empty((n, m), dtype=ca.dtype, device=ca.device)
    rows = max(1, _HULL_CHUNK // max(m, 1))
    for i in range(0, n, rows):
        a = ca[i:i + rows]
        pts = torch.cat([a[:, None].expand(-1, m, -1, -1),
                         cb[None].expand(a.shape[0], -1, -1, -1)], 2)
        out[i:i + rows] = _union_hull_area(pts.reshape(-1, 8, 2)).reshape(
            a.shape[0], m)
    return out


def boxes_giou3d(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) 3D GIoU: K7's BEV overlap and the union
    hull.  The union height is the reference's min(amax, bmax) -
    min(amin, bmin), kept as it is (not max(amax, bmax) - min(amin,
    bmin))."""
    bev_a, bev_b = boxes3d_to_bev(boxes_a), boxes3d_to_bev(boxes_b)
    ov3d = boxes_overlap_bev(bev_a, bev_b) * _height_overlap(boxes_a,
                                                             boxes_b)
    hull_bev = boxes_union_hull_bev(bev_a, bev_b)
    amin, amax = _z_range(boxes_a)
    bmin, bmax = _z_range(boxes_b)
    union_h = torch.clamp(torch.minimum(amax[:, None], bmax[None, :])
                          - torch.minimum(amin[:, None], bmin[None, :]),
                          min=0.0)
    hull3d = torch.clamp(hull_bev * union_h, min=1e-6)
    vol_a = torch.prod(boxes_a[:, 3:6], 1)[:, None]
    vol_b = torch.prod(boxes_b[:, 3:6], 1)[None, :]
    union3d = torch.clamp(vol_a + vol_b - ov3d, min=1e-6)
    return ov3d / union3d - (hull3d - union3d) / hull3d


def _iou_aligned(a, b):
    """(N, 4) x (M, 4) [x1, y1, x2, y2] -> (N, M) IoU."""
    ix = torch.clamp(torch.minimum(a[:, None, 2], b[None, :, 2])
                     - torch.maximum(a[:, None, 0], b[None, :, 0]), min=0)
    iy = torch.clamp(torch.minimum(a[:, None, 3], b[None, :, 3])
                     - torch.maximum(a[:, None, 1], b[None, :, 1]), min=0)
    inter = ix * iy
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def _aligned_corners(boxes):
    """(N, 7) -> (N, 4) [x1, y1, x2, y2] of the sizes as given."""
    return torch.stack([boxes[:, 0] - boxes[:, 3] / 2,
                        boxes[:, 1] - boxes[:, 4] / 2,
                        boxes[:, 0] + boxes[:, 3] / 2,
                        boxes[:, 1] + boxes[:, 4] / 2], 1)


def boxes_iou_normal(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) BEV IoU of the boxes taken axis-aligned
    (heading ignored)."""
    return _iou_aligned(_aligned_corners(boxes_a), _aligned_corners(boxes_b))


def boxes3d_lidar_to_aligned_bev_boxes(boxes3d):
    """(N, 7) -> (N, 4) [x1, y1, x2, y2] of the nearest axis-aligned box:
    within pi/4 of the x axis the sizes stay, else dx and dy swap."""
    rot = torch.abs(limit_period(boxes3d[:, 6], offset=0.5, period=math.pi))
    dims = torch.where(rot[:, None] < math.pi / 4, boxes3d[:, 3:5],
                       boxes3d[:, [4, 3]])
    return torch.cat([boxes3d[:, 0:2] - dims / 2,
                      boxes3d[:, 0:2] + dims / 2], 1)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) IoU of the nearest axis-aligned boxes."""
    return _iou_aligned(boxes3d_lidar_to_aligned_bev_boxes(boxes_a),
                        boxes3d_lidar_to_aligned_bev_boxes(boxes_b))

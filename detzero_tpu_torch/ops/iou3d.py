"""Rotated 3D IoU (port of `detzero_tpu/ops/iou3d.py`): the N x M matrix
`boxes_iou3d`, which the PDV head's RoI targets take, and the matched pairs
`boxes_iou3d_pairwise`, the target of the center head's IoU branch.  The
BEV overlaps are kernel K7 (`ops/iou_bev.boxes_overlap_bev`, re-exported
here as the reference's module exports its dispatch) and kernel K6
(`ops/iou_bev.boxes_overlap_bev_pairwise`); the heights and volumes are
torch ops around them, as the reference computes them in jnp."""

from __future__ import annotations

import torch

from detzero_tpu_torch.ops.box_ops import boxes3d_to_bev
from detzero_tpu_torch.ops.iou_bev import (
    boxes_overlap_bev, boxes_overlap_bev_pairwise,
)


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

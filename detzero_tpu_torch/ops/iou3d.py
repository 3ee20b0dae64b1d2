"""Rotated 3D IoU of matched box pairs (port of
`detzero_tpu/ops/iou3d.py::boxes_iou3d_pairwise`), the target of the center
head's IoU branch.  The BEV overlap is kernel K6
(`ops/iou_bev.boxes_overlap_bev_pairwise`)."""

from __future__ import annotations

import torch

from detzero_tpu_torch.ops.box_ops import boxes3d_to_bev
from detzero_tpu_torch.ops.iou_bev import boxes_overlap_bev_pairwise


def boxes_iou3d_pairwise(boxes_a, boxes_b):
    """(N, 7) x (N, 7) -> (N,) 3D IoU of pair i = (boxes_a[i], boxes_b[i])."""
    ov_bev = boxes_overlap_bev_pairwise(boxes3d_to_bev(boxes_a),
                                        boxes3d_to_bev(boxes_b))
    amax = boxes_a[:, 2] + boxes_a[:, 5] / 2
    amin = boxes_a[:, 2] - boxes_a[:, 5] / 2
    bmax = boxes_b[:, 2] + boxes_b[:, 5] / 2
    bmin = boxes_b[:, 2] - boxes_b[:, 5] / 2
    ov_h = torch.clamp(torch.minimum(amax, bmax) - torch.maximum(amin, bmin),
                       min=0.0)
    ov3d = ov_bev * ov_h
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return ov3d / torch.clamp(vol_a + vol_b - ov3d, min=1e-6)

"""Box geometry used by decode, NMS and the PDV second stage (port of the
matching functions of `detzero_tpu/ops/box_ops.py`)."""

from __future__ import annotations

import math

import torch


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap to [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def boxes3d_to_bev(boxes3d):
    """(N, 7) -> (N, 5) [x, y, dx, dy, heading]."""
    return boxes3d[:, [0, 1, 3, 4, 6]]


def rotate_points_along_z(points, angle):
    """points (..., N, 3+), angle (...,) -> rotated about +z; the channels
    past xy are kept."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xy = torch.stack([x * c - y * s, x * s + y * c], -1)
    return torch.cat([xy, points[..., 2:]], -1)


_CORNERS_3D = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
               (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))


def boxes_to_corners_3d(boxes):
    """(N, 7) -> (N, 8, 3): bottom 4 then top 4, z from the box centre."""
    template = torch.tensor(_CORNERS_3D, dtype=boxes.dtype,
                            device=boxes.device) / 2.0
    corners = rotate_points_along_z(template[None] * boxes[:, None, 3:6],
                                    boxes[:, 6])
    return corners + boxes[:, None, :3]


def bilinear_sample_bev(bev_hwc, xy, voxel_size, pc_range,
                        feature_map_stride: int):
    """Bilinear samples of a BEV map at metric (x, y): bev_hwc (H, W, C),
    xy (N, 2) -> (N, C) float32 (the weights are float32)."""
    h, w, _ = bev_hwc.shape
    fx = (xy[:, 0] - pc_range[0]) / (voxel_size[0] * feature_map_stride) \
        - 0.5
    fy = (xy[:, 1] - pc_range[1]) / (voxel_size[1] * feature_map_stride) \
        - 0.5
    x0 = torch.clamp(torch.floor(fx).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(fy).long(), 0, h - 2)
    tx = torch.clamp(fx - x0, 0.0, 1.0)[:, None]
    ty = torch.clamp(fy - y0, 0.0, 1.0)[:, None]
    f00, f01 = bev_hwc[y0, x0].float(), bev_hwc[y0, x0 + 1].float()
    f10, f11 = bev_hwc[y0 + 1, x0].float(), bev_hwc[y0 + 1, x0 + 1].float()
    return ((1 - ty) * ((1 - tx) * f00 + tx * f01)
            + ty * ((1 - tx) * f10 + tx * f11))


def box_keypoints_bev(boxes):
    """(N, 7) -> (N, 5, 2): the BEV centre and the 4 side midpoints."""
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    hx, hy = boxes[:, 3] / 2, boxes[:, 4] / 2
    zero = torch.zeros_like(hx)
    ox = torch.stack([zero, hx, -hx, zero, zero], 1)
    oy = torch.stack([zero, zero, zero, hy, -hy], 1)
    x = ox * c[:, None] - oy * s[:, None] + boxes[:, None, 0]
    y = ox * s[:, None] + oy * c[:, None] + boxes[:, None, 1]
    return torch.stack([x, y], -1)

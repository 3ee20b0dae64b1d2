"""Box geometry on tensors of the caller's device (port of
`detzero_tpu/ops/box_ops.py`): decode, NMS and the PDV second stage use
the rotations, corners and keypoints; the rest (range masks, poses,
points in boxes, voxel centres) serve the host tools and tests.
`ops/box_np.py` keeps the numpy twins of `boxes_to_corners_bev` and
`points_in_boxes` that the data path runs."""

from __future__ import annotations

import math

import torch


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap to [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotation_matrix_2d(angle):
    """(...,) -> (..., 2, 2) rotation about +z."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


_CORNERS_BEV = ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def boxes_to_corners_bev(boxes):
    """(N, 5+) [x, y, dx, dy, heading, ...] -> (N, 4, 2) ccw corners."""
    template = torch.tensor(_CORNERS_BEV, dtype=boxes.dtype,
                            device=boxes.device)
    corners = template[None] * boxes[:, None, 2:4]
    c = torch.cos(boxes[:, 4])[:, None]
    s = torch.sin(boxes[:, 4])[:, None]
    x, y = corners[..., 0], corners[..., 1]
    corners = torch.stack([x * c - y * s, x * s + y * c], -1)
    return corners + boxes[:, None, :2]


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


def enlarge_box3d(boxes3d, extra_width=(0.0, 0.0, 0.0)):
    """(N, 7+) with the sizes grown by extra (dx, dy, dz)."""
    extra = torch.as_tensor(extra_width, dtype=boxes3d.dtype,
                            device=boxes3d.device)
    return torch.cat([boxes3d[:, :3], boxes3d[:, 3:6] + extra,
                      boxes3d[:, 6:]], 1)


def scale_box3d(boxes3d, factor: float):
    """(N, 7+) with the sizes times `factor`."""
    return torch.cat([boxes3d[:, :3], boxes3d[:, 3:6] * factor,
                      boxes3d[:, 6:]], 1)


def points_in_boxes(points, boxes):
    """(N, 3+), (M, 7) -> (N, M) bool: the point in the box's frame within
    its half extents (+1e-6)."""
    shifted = points[:, None, :3] - boxes[None, :, :3]
    c, s = torch.cos(-boxes[:, 6]), torch.sin(-boxes[:, 6])
    lx = shifted[..., 0] * c[None, :] - shifted[..., 1] * s[None, :]
    ly = shifted[..., 0] * s[None, :] + shifted[..., 1] * c[None, :]
    return ((torch.abs(lx) <= boxes[None, :, 3] / 2 + 1e-6)
            & (torch.abs(ly) <= boxes[None, :, 4] / 2 + 1e-6)
            & (torch.abs(shifted[..., 2]) <= boxes[None, :, 5] / 2 + 1e-6))


def mask_boxes_outside_range(boxes, limit_range, min_num_corners: int = 1):
    """(N, 7+) -> (N,) bool: boxes with at least `min_num_corners` BEV
    corners inside [x0, y0, _, x1, y1, _]."""
    corners = boxes_to_corners_bev(boxes3d_to_bev(boxes))
    lr = [float(v) for v in limit_range]
    inside = ((corners[..., 0] >= lr[0]) & (corners[..., 0] <= lr[3])
              & (corners[..., 1] >= lr[1]) & (corners[..., 1] <= lr[4]))
    return inside.sum(1) >= min_num_corners


def transform_boxes3d(boxes, pose):
    """(N, 7+[vx, vy, ...]) by a 4x4 pose: centres transformed, heading
    turned by the pose's yaw, velocities rotated, the rest kept."""
    centers = boxes[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    yaw = torch.atan2(pose[1, 0], pose[0, 0])
    out = [centers, boxes[:, 3:6], (boxes[:, 6] + yaw)[:, None]]
    if boxes.shape[1] > 7:
        out.append(boxes[:, 7:9] @ pose[:2, :2].T)
        if boxes.shape[1] > 9:
            out.append(boxes[:, 9:])
    return torch.cat(out, -1)


def inverse_pose(pose):
    """The inverse of a rigid 4x4 transform."""
    r, t = pose[:3, :3], pose[:3, 3]
    inv = torch.eye(4, dtype=pose.dtype, device=pose.device)
    inv[:3, :3] = r.T
    inv[:3, 3] = -r.T @ t
    return inv


def get_voxel_centers(voxel_coords, downsample_times, voxel_size,
                      point_cloud_range):
    """(N, 3) zyx voxel coordinates -> (N, 3) float32 xyz centres."""
    coords = voxel_coords.flip(-1).float()
    vs = torch.as_tensor(voxel_size, dtype=torch.float32,
                         device=coords.device) * downsample_times
    pc_min = torch.as_tensor(point_cloud_range[:3], dtype=torch.float32,
                             device=coords.device)
    return (coords + 0.5) * vs + pc_min

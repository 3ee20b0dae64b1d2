"""KITTI camera / legacy-lidar box format converters (host-side NumPy;
port of detzero_tpu/utils/kitti_convert.py, the same functions computing
the same bits).

Capability parity with the reference's box_utils KITTI surface
(utils/detzero_utils/box_utils.py:92-142, 181-267). DetZero's Waymo
pipeline never touches these at runtime — they exist for interoperability
with KITTI-format exports and legacy tooling — so they live here as plain
NumPy, off the device path.

Coordinate conventions:
  * lidar:        x forward, y left, z up; boxes (x, y, z, dx, dy, dz,
                  heading) with (x, y, z) the box *center*, heading CCW
                  around +z from +x.
  * KITTI camera: x right, y down, z forward; boxes (x, y, z, l, h, w, ry)
                  with y at the box *bottom*, ry around -y (clockwise in
                  BEV).
  * "fakelidar" (legacy OpenPCDet/KITTI lidar): boxes (x, y, z, w, l, h, r)
                  with z at the box bottom and r = -heading - pi/2.

heading <-> ry:  heading = -(ry + pi/2),  ry = -(heading + pi/2).
"""

from __future__ import annotations

import numpy as np


class SimpleCalib:
    """Minimal rect-camera calibration (duck-typed like OpenPCDet's).

    Args:
        P2: (3, 4) camera projection matrix.
        R0: (3, 3) rectification rotation.
        Tr_velo_to_cam: (3, 4) lidar -> camera extrinsics.
    """

    def __init__(self, P2=None, R0=None, Tr_velo_to_cam=None):
        self.P2 = np.eye(3, 4) if P2 is None else np.asarray(P2, np.float64)
        self.R0 = np.eye(3) if R0 is None else np.asarray(R0, np.float64)
        if Tr_velo_to_cam is None:
            # canonical axis permutation lidar->camera: cam x = -lidar y,
            # cam y = -lidar z, cam z = lidar x
            Tr_velo_to_cam = np.array([[0., -1., 0., 0.],
                                       [0., 0., -1., 0.],
                                       [1., 0., 0., 0.]])
        self.V2C = np.asarray(Tr_velo_to_cam, np.float64)

    def lidar_to_rect(self, pts_lidar):
        pts = np.concatenate([pts_lidar, np.ones((len(pts_lidar), 1))], axis=1)
        return (self.R0 @ (self.V2C @ pts.T)).T

    def rect_to_lidar(self, pts_rect):
        V2C_h = np.concatenate([self.V2C, [[0, 0, 0, 1]]], axis=0)
        R0_h = np.eye(4)
        R0_h[:3, :3] = self.R0
        inv = np.linalg.inv(R0_h @ V2C_h)
        pts = np.concatenate([pts_rect, np.ones((len(pts_rect), 1))], axis=1)
        return (inv @ pts.T).T[:, :3]

    def rect_to_img(self, pts_rect):
        pts = np.concatenate([pts_rect, np.ones((len(pts_rect), 1))], axis=1)
        uvw = (self.P2 @ pts.T).T
        depth = uvw[:, 2]
        uv = uvw[:, :2] / np.clip(depth[:, None], 1e-6, None)
        return uv, depth


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) [x, y, z, l, h, w, ry] rect-camera -> lidar center boxes
    (box_utils.py:92-108)."""
    b = np.asarray(boxes3d_camera, np.float64)
    l, h, w, ry = b[:, 3:4], b[:, 4:5], b[:, 5:6], b[:, 6:7]
    xyz = calib.rect_to_lidar(b[:, :3])
    xyz[:, 2] += h[:, 0] / 2  # bottom -> center
    return np.concatenate([xyz, l, w, h, -(ry + np.pi / 2)], axis=1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """(N, 7) lidar center boxes -> [x, y, z, l, h, w, ry] rect-camera
    (box_utils.py:181-198)."""
    b = np.asarray(boxes3d_lidar, np.float64)
    l, w, h = b[:, 3:4], b[:, 4:5], b[:, 5:6]
    xyz = b[:, :3].copy()
    xyz[:, 2] -= h[:, 0] / 2  # center -> bottom
    xyz_cam = calib.lidar_to_rect(xyz)
    ry = -b[:, 6:7] - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, ry], axis=1)


def boxes3d_kitti_fakelidar_to_lidar(boxes3d_fakelidar):
    """Legacy (x, y, z_bottom, w, l, h, r) -> center boxes
    (box_utils.py:111-125)."""
    b = np.asarray(boxes3d_fakelidar, np.float64)
    w, l, h, r = b[:, 3:4], b[:, 4:5], b[:, 5:6], b[:, 6:7]
    xyz = b[:, :3].copy()
    xyz[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz, l, w, h, -(r + np.pi / 2)], axis=1)


def boxes3d_kitti_lidar_to_fakelidar(boxes3d_lidar):
    """Center boxes -> legacy (x, y, z_bottom, w, l, h, r)
    (box_utils.py:128-141)."""
    b = np.asarray(boxes3d_lidar, np.float64)
    dx, dy, dz, heading = b[:, 3:4], b[:, 4:5], b[:, 5:6], b[:, 6:7]
    xyz = b[:, :3].copy()
    xyz[:, 2] -= dz[:, 0] / 2
    return np.concatenate([xyz, dy, dx, dz, -heading - np.pi / 2], axis=1)


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) camera boxes -> (N, 8, 3) corners (box_utils.py:200-243).

    Corner order matches the reference's template: bottom quad 0-3
    (when bottom_center) then top quad 4-7; rotation ry around camera y.
    """
    b = np.asarray(boxes3d, np.float64)
    n = len(b)
    l, h, w, ry = b[:, 3], b[:, 4], b[:, 5], b[:, 6]
    xs = np.stack([l, l, -l, -l, l, l, -l, -l], axis=1) / 2
    zs = np.stack([w, -w, -w, w, w, -w, -w, w], axis=1) / 2
    if bottom_center:
        ys = np.zeros((n, 8))
        ys[:, 4:] = -h[:, None]
    else:
        ys = np.stack([h, h, h, h, -h, -h, -h, -h], axis=1) / 2
    c, s = np.cos(ry), np.sin(ry)
    # camera-frame y-axis rotation applied as corners @ R (row-vector form)
    zero, one = np.zeros(n), np.ones(n)
    R = np.stack([np.stack([c, zero, -s], axis=1),
                  np.stack([zero, one, zero], axis=1),
                  np.stack([s, zero, c], axis=1)], axis=1)
    corners = np.stack([xs, ys, zs], axis=2) @ R
    return (corners + b[:, None, :3]).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """(N, 7) camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes
    (box_utils.py:246-266)."""
    corners = boxes3d_to_corners3d_kitti_camera(boxes3d)
    uv, _ = calib.rect_to_img(corners.reshape(-1, 3))
    uv = uv.reshape(-1, 8, 2)
    boxes2d = np.concatenate([uv.min(axis=1), uv.max(axis=1)], axis=1)
    if image_shape is not None:
        hgt, wid = image_shape[0], image_shape[1]
        boxes2d[:, [0, 2]] = np.clip(boxes2d[:, [0, 2]], 0, wid - 1)
        boxes2d[:, [1, 3]] = np.clip(boxes2d[:, [1, 3]], 0, hgt - 1)
    return boxes2d


def boxes3d_lidar_to_imageboxes(boxes3d_lidar, calib, image_shape=None):
    """Lidar boxes straight to image boxes (box_utils.py:321-346
    boxes3d_to_boxes2d, expressed through the calib object)."""
    cam = boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib)
    return boxes3d_kitti_camera_to_imageboxes(cam, calib, image_shape)

"""Config-driven data-processing queue (port of detzero_tpu/data/processor.py;
reference DataProcessor, processor/data_processor.py:11).  The queue ends in
a fixed point budget and a validity mask: the model builds its pillar table
on the device, so no host voxelizer runs and no ragged tensors cross to the
device.  Shuffling and sampling draw from the `rng` the caller passes, in
the order in which the reference draws from numpy's global generator."""

from __future__ import annotations

import numpy as np

from detzero_tpu_torch.ops import box_np


class DataProcessor:
    """Builds a processing queue from a list of cfg dicts with NAME keys
    (same config surface as the reference, data_processor.py:20-22)."""

    def __init__(self, cfg_list, point_cloud_range, training: bool,
                 rng: np.random.RandomState,
                 num_point_budget: int = 200_000):
        self.rng = rng
        self.pc_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_budget = num_point_budget
        self.queue = []
        for cur in cfg_list or []:
            name = cur["NAME"]
            fn = getattr(self, name, None)
            if fn is None:
                raise KeyError(f"unknown processor {name}")
            self.queue.append((fn, cur))

    def __call__(self, data):
        for fn, cfg in self.queue:
            data = fn(data, cfg)
        return self.pad_points(data)

    # ------------------------------------------------------------------
    def mask_points_and_boxes_outside_range(self, data, cfg):
        pts = data["points"]
        m = (
            (pts[:, 0] >= self.pc_range[0]) & (pts[:, 0] <= self.pc_range[3])
            & (pts[:, 1] >= self.pc_range[1]) & (pts[:, 1] <= self.pc_range[4])
            & (pts[:, 2] >= self.pc_range[2]) & (pts[:, 2] <= self.pc_range[5])
        )
        data["points"] = pts[m]
        if self.training and cfg.get("REMOVE_OUTSIDE_BOXES", True) and \
                "gt_boxes" in data and len(data["gt_boxes"]):
            corners = box_np.boxes_to_corners_bev(
                box_np.boxes3d_to_bev(data["gt_boxes"]))
            inside = (
                (corners[..., 0] >= self.pc_range[0])
                & (corners[..., 0] <= self.pc_range[3])
                & (corners[..., 1] >= self.pc_range[1])
                & (corners[..., 1] <= self.pc_range[4])
            ).sum(axis=1) >= cfg.get("MIN_NUM_CORNERS", 1)
            for k in ("gt_boxes", "gt_names", "gt_classes"):
                if k in data:
                    data[k] = data[k][inside]
        return data

    def shuffle_points(self, data, cfg):
        if self.training or cfg.get("SHUFFLE_ENABLED", {}).get("test", False):
            idx = self.rng.permutation(len(data["points"]))
            data["points"] = data["points"][idx]
        return data

    def sample_points(self, data, cfg):
        """Subsample to NUM_POINTS with near/far awareness (reference
        sample_points:93 keeps far points preferentially when undersampling)."""
        num = int(cfg.get("NUM_POINTS", {}).get(
            "train" if self.training else "test", self.num_point_budget))
        pts = data["points"]
        if len(pts) <= num:
            data["points"] = pts
            return data
        depth = np.linalg.norm(pts[:, :3], axis=1)
        far = pts[depth >= 40.0]
        near = pts[depth < 40.0]
        if len(far) >= num:
            idx = self.rng.choice(len(far), num, replace=False)
            data["points"] = far[idx]
        else:
            k = num - len(far)
            idx = self.rng.choice(len(near), k, replace=False)
            data["points"] = np.concatenate([far, near[idx]])
        return data

    def transform_points_to_voxels_placeholder(self, data, cfg):
        """The pillar table is built on the device; keep grid metadata only
        (reference :51 does the same for the dynamic-VFE path)."""
        vs = np.asarray(cfg["VOXEL_SIZE"], np.float32)
        grid = np.round((self.pc_range[3:] - self.pc_range[:3]) / vs).astype(int)
        data["voxel_size"] = vs
        data["grid_size"] = grid
        return data

    # alias: config parity with the reference's eager-voxelizer name
    transform_points_to_voxels = transform_points_to_voxels_placeholder

    def pad_points(self, data):
        """Final step: the fixed budget and its validity mask."""
        pts = data["points"]
        n = min(len(pts), self.num_point_budget)
        out = np.zeros((self.num_point_budget, pts.shape[1]), np.float32)
        out[:n] = pts[:n]
        data["points"] = out
        data["points_valid"] = np.arange(self.num_point_budget) < n
        return data

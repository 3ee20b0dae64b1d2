"""GT-database paste-in sampling (port of
detzero_tpu/data/database_sampler.py; reference DataBaseSampler,
augmentor/database_sampler.py:12): keep a per-class pool of cropped GT objects
(box + points), paste a target number into each scene after rejecting
candidates that BEV-collide with existing GTs or already-pasted boxes, and
remove scene points inside the pasted boxes.

The database itself is built by tools/waymo_preprocess (per-class frame
subsampling, points_in_boxes cropping — waymo_preprocess.py:153-196); here we
consume its pickle {class_name: [{box, points, ...}, ...]}."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from detzero_tpu_torch.core.mesh import rank_rng
from detzero_tpu_torch.ops import box_np


class DataBaseSampler:
    def __init__(self, cfg, class_names, root_path=None, logger=None):
        self.class_names = list(class_names)
        self.sample_groups = {}
        for group in cfg.get("SAMPLE_GROUPS", []):
            name, num = group.split(":") if isinstance(group, str) else group
            if name in self.class_names:
                self.sample_groups[name] = int(num)
        self.db = {}
        db_path = cfg.get("DB_INFO_PATH")
        if db_path:
            p = Path(root_path or ".") / db_path
            if p.exists():
                with open(p, "rb") as f:
                    infos = pickle.load(f)
                for name in self.class_names:
                    self.db[name] = infos.get(name, [])
                if logger:
                    logger.info("gt database: " + ", ".join(
                        f"{k}:{len(v)}" for k, v in self.db.items()))
        self.min_points = cfg.get("MIN_POINTS", 5)
        # SEED on rank 0, (SEED, rank) on the others (core/mesh.rank_rng)
        self.rng = rank_rng(cfg.get("SEED", None))

    def set_database(self, db):
        """Inject an in-memory database (tests / programmatic use)."""
        self.db = db

    def __call__(self, data):
        if not self.db:
            return data
        gt_boxes = data.get("gt_boxes")
        gt_names = data.get("gt_names")
        if gt_boxes is None:
            gt_boxes = np.zeros((0, 7), np.float32)
            gt_names = np.zeros(0, dtype=object)
        existing = gt_boxes[:, :7].copy()
        new_boxes, new_names, new_points = [], [], []
        for name, target in self.sample_groups.items():
            pool = self.db.get(name, [])
            if not pool:
                continue
            need = max(0, target - int((gt_names == name).sum()))
            if need == 0:
                continue
            cand_idx = self.rng.choice(len(pool), min(need * 2, len(pool)),
                                       replace=False)
            placed = 0
            for ci in cand_idx:
                if placed >= need:
                    break
                info = pool[ci]
                box = np.asarray(info["box"], np.float32)
                pts = np.asarray(info["points"], np.float32)
                if len(pts) < self.min_points:
                    continue
                all_boxes = existing if not new_boxes else np.concatenate(
                    [existing, np.stack(new_boxes)])
                if len(all_boxes):
                    iou = box_np.boxes_iou_bev(
                        box_np.boxes3d_to_bev(box[None]),
                        box_np.boxes3d_to_bev(all_boxes),
                    )
                    if iou.max() > 1e-3:  # any BEV collision rejects
                        continue
                new_boxes.append(box[:7])
                new_names.append(name)
                new_points.append(pts)
                placed += 1
        if not new_boxes:
            return data
        nb = np.stack(new_boxes)
        # remove scene points inside pasted boxes (reference removes only the
        # current sweep's points, database_sampler.py:155-161)
        pts = data["points"]
        keep = np.ones(len(pts), bool)
        for b in nb:
            keep &= ~box_np.points_in_rotated_box(pts, b)
        obj_pts = np.concatenate(new_points)
        if obj_pts.shape[1] < pts.shape[1]:
            pad = np.zeros((len(obj_pts), pts.shape[1] - obj_pts.shape[1]),
                           np.float32)
            obj_pts = np.concatenate([obj_pts, pad], axis=1)
        data["points"] = np.concatenate([pts[keep], obj_pts[:, :pts.shape[1]]])
        if gt_boxes.shape[1] > 7:
            nb = np.concatenate(
                [nb, np.zeros((len(nb), gt_boxes.shape[1] - 7), np.float32)], 1)
        data["gt_boxes"] = np.concatenate([gt_boxes, nb]) if len(gt_boxes) else nb
        data["gt_names"] = np.concatenate(
            [np.asarray(gt_names, object), np.asarray(new_names, object)])
        return data

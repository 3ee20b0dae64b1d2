"""Training augmentation queue (port of detzero_tpu/data/augmentor.py;
reference DataAugmentor, augmentor/data_augmentor.py:10): gt-sampling
paste-in plus global flip / rotation / scaling / translation, velocity
columns included.  Each world transform records its inverse matrix
(`aug_matrix_inv`) so TTA/ensembling can undo it (reference :44-160).
The world transforms draw from the `rng` the caller passes, in the order in
which the reference draws from numpy's global generator; the GT sampler
keeps its own generator, as the reference's does."""

from __future__ import annotations

import numpy as np

from detzero_tpu_torch.data.database_sampler import DataBaseSampler


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


class DataAugmentor:
    def __init__(self, cfg_list, class_names, rng: np.random.RandomState,
                 root_path=None, logger=None):
        self.rng = rng
        self.class_names = list(class_names)
        self.queue = []
        for cur in cfg_list or []:
            name = cur["NAME"]
            if name in (cur.get("DISABLE_AUG_LIST") or []):
                continue
            if name == "gt_sampling":
                sampler = DataBaseSampler(cur, class_names, root_path, logger)
                self.queue.append((sampler, cur))
            else:
                fn = getattr(self, name, None)
                if fn is None:
                    raise KeyError(f"unknown augmentor {name}")
                self.queue.append((fn, cur))

    def __call__(self, data):
        data.setdefault("aug_matrix_inv", np.eye(3))
        data.setdefault("aug_flip", [False, False])
        data.setdefault("aug_scale", 1.0)
        for fn, cfg in self.queue:
            data = fn(data, cfg) if not isinstance(fn, DataBaseSampler) else fn(data)
        return data

    # ------------------------------------------------------------------
    def random_world_flip(self, data, cfg):
        for axis in cfg.get("ALONG_AXIS_LIST", ["x"]):
            if self.rng.rand() >= 0.5:
                continue
            pts, boxes = data["points"], data.get("gt_boxes")
            if axis == "x":  # flip over x axis: y -> -y
                pts[:, 1] = -pts[:, 1]
                if boxes is not None and len(boxes):
                    boxes[:, 1] = -boxes[:, 1]
                    boxes[:, 6] = -boxes[:, 6]
                    if boxes.shape[1] > 8:
                        boxes[:, 8] = -boxes[:, 8]
                data["aug_flip"][0] = not data["aug_flip"][0]
                flip = np.diag([1.0, -1.0, 1.0])
            else:  # y axis: x -> -x
                pts[:, 0] = -pts[:, 0]
                if boxes is not None and len(boxes):
                    boxes[:, 0] = -boxes[:, 0]
                    boxes[:, 6] = np.pi - boxes[:, 6]
                    if boxes.shape[1] > 7:
                        boxes[:, 7] = -boxes[:, 7]
                data["aug_flip"][1] = not data["aug_flip"][1]
                flip = np.diag([-1.0, 1.0, 1.0])
            data["aug_matrix_inv"] = data["aug_matrix_inv"] @ flip
        return data

    def random_world_rotation(self, data, cfg):
        lo, hi = cfg.get("WORLD_ROT_ANGLE", [-0.78539816, 0.78539816])
        angle = self.rng.uniform(lo, hi)
        rot = _rot_z(angle)
        data["points"][:, :3] = data["points"][:, :3] @ rot.T
        boxes = data.get("gt_boxes")
        if boxes is not None and len(boxes):
            boxes[:, :3] = boxes[:, :3] @ rot.T
            boxes[:, 6] += angle
            if boxes.shape[1] > 8:
                boxes[:, 7:9] = boxes[:, 7:9] @ rot[:2, :2].T
        data["aug_matrix_inv"] = data["aug_matrix_inv"] @ _rot_z(-angle)
        data["aug_rot"] = data.get("aug_rot", 0.0) + angle
        return data

    def random_world_scaling(self, data, cfg):
        lo, hi = cfg.get("WORLD_SCALE_RANGE", [0.95, 1.05])
        s = self.rng.uniform(lo, hi)
        data["points"][:, :3] *= s
        boxes = data.get("gt_boxes")
        if boxes is not None and len(boxes):
            boxes[:, :6] *= s
            if boxes.shape[1] > 8:
                boxes[:, 7:9] *= s
        data["aug_matrix_inv"] = data["aug_matrix_inv"] / s
        data["aug_scale"] = data.get("aug_scale", 1.0) * s
        return data

    def random_world_translation(self, data, cfg):
        std = cfg.get("NOISE_TRANSLATE_STD", [0.0, 0.0, 0.0])
        t = self.rng.normal(0, np.maximum(std, 1e-12), 3)
        data["points"][:, :3] += t
        boxes = data.get("gt_boxes")
        if boxes is not None and len(boxes):
            boxes[:, :3] += t
        data["aug_translate"] = data.get("aug_translate", np.zeros(3)) + t
        return data

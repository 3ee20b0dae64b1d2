"""Detection dataset template (port of detzero_tpu/data/dataset.py).

The reference DatasetTemplate (detection/datasets/dataset.py:15):
multi-sweep sample assembly (clamped sweep window, NLZ filter, tanh
intensity, pose-chain transform, per-point time-offset channel), augment ->
encode -> process pipeline, and a collate that emits fixed-shape numpy
batches (points padded to the budget, GT padded to max_objs) in place of
the reference's ragged batch-index prefixing (collate_batch:260).

Randomness: augmentation and point shuffling draw from `self.rng`, one
`np.random.RandomState` that the caller may pass (a fresh, unseeded one
otherwise).  With a single loader thread it is drawn in the reference's
order, so `rng=np.random.RandomState(s)` gives the reference's draws after
`np.random.seed(s)`."""

from __future__ import annotations

import numpy as np
import torch

from detzero_tpu_torch.data.augmentor import DataAugmentor
from detzero_tpu_torch.data.point_encoder import PointFeatureEncoder
from detzero_tpu_torch.data.processor import DataProcessor
from detzero_tpu_torch.data.tta import TestTimeAugmentor


def merge_sweeps(cur_points, cur_pose, sweep_points, sweep_poses, sweep_dts,
                 nlz_col: int | None = 5, intensity_col: int = 3):
    """Fuse past sweeps into the current frame (reference merge_sweeps,
    dataset.py:167): NLZ filter, tanh(intensity), transform each sweep into
    the current lidar frame via inv(cur_pose) @ sweep_pose, and append a
    per-point time-offset channel."""
    inv_cur = np.linalg.inv(cur_pose)
    outs = []
    for pts, pose, dt in zip(
            [cur_points] + list(sweep_points),
            [cur_pose] + list(sweep_poses),
            [0.0] + list(sweep_dts)):
        pts = np.asarray(pts, np.float32)
        if nlz_col is not None and pts.shape[1] > nlz_col:
            pts = pts[pts[:, nlz_col] == -1]  # keep non-NLZ (-1 = no zone)
            pts = np.delete(pts, nlz_col, axis=1)
        pts = pts.copy()
        pts[:, intensity_col] = np.tanh(pts[:, intensity_col])
        rel = inv_cur @ pose
        xyz1 = np.concatenate([pts[:, :3], np.ones((len(pts), 1))], axis=1)
        pts[:, :3] = (xyz1 @ rel.T)[:, :3]
        t = np.full((len(pts), 1), dt, np.float32)
        outs.append(np.concatenate([pts, t], axis=1).astype(np.float32))
    return np.concatenate(outs, axis=0)


def get_sweep_idxs(cur_idx: int, sweep_count, total: int):
    """Clamped window of past frame indices (reference get_sweep_idxs:143).
    sweep_count = [-k, 0] means k past sweeps."""
    lo = max(0, cur_idx + sweep_count[0])
    return list(range(lo, cur_idx))


class DatasetTemplate:
    def __init__(self, dataset_cfg, class_names, training: bool,
                 root_path=None, logger=None,
                 rng: np.random.RandomState | None = None):
        self.cfg = dataset_cfg
        self.rng = rng if rng is not None else np.random.RandomState()
        self.class_names = list(class_names)
        self.training = training
        self.logger = logger
        self.pc_range = np.asarray(dataset_cfg["POINT_CLOUD_RANGE"], np.float32)
        self.max_objs = int(dataset_cfg.get("MAX_OBJS", 500))

        pfe_cfg = dataset_cfg.get("POINT_FEATURE_ENCODING", {})
        self.point_encoder = PointFeatureEncoder(
            used_features=pfe_cfg.get(
                "used_feature_list",
                ["x", "y", "z", "intensity", "elongation", "time_offset"]),
            src_features=pfe_cfg.get(
                "src_feature_list",
                ["x", "y", "z", "intensity", "elongation", "time_offset"]),
        )
        self.augmentor = DataAugmentor(
            dataset_cfg.get("DATA_AUGMENTOR", {}).get("AUG_CONFIG_LIST"),
            class_names, self.rng, root_path, logger) if training else None
        self.processor = DataProcessor(
            dataset_cfg.get("DATA_PROCESSOR"), self.pc_range, training,
            self.rng, num_point_budget=int(
                dataset_cfg.get("NUM_POINT_BUDGET", 200_000)))
        self.tta = (TestTimeAugmentor(dataset_cfg.get("TTA_CONFIG"))
                    if (not training and dataset_cfg.get("TTA", False)) else None)

    # ------------------------------------------------------------------
    def prepare_data(self, data):
        """augment -> class filter/encode -> (TTA fanout) -> process.
        Returns one dict (train) or a list of dicts (TTA)."""
        if self.training and self.augmentor is not None:
            data = self.augmentor(data)
        if "gt_names" in data and data.get("gt_boxes") is not None:
            keep = np.array([n in self.class_names for n in data["gt_names"]],
                            bool)
            data["gt_boxes"] = np.asarray(data["gt_boxes"], np.float32)[keep]
            data["gt_classes"] = np.array(
                [self.class_names.index(n) for n in
                 np.asarray(data["gt_names"])[keep]], np.int32)
            data["gt_names"] = np.asarray(data["gt_names"])[keep]
        data["points"] = self.point_encoder(data["points"])
        if self.tta is not None:
            return [self.processor(d) for d in self.tta(data)]
        return self.processor(data)

    # ------------------------------------------------------------------
    def collate_batch(self, samples):
        """List of prepared dicts -> fixed-shape numpy batch. TTA lists are
        flattened into the batch like the reference (collate_batch:263-274)."""
        flat = []
        for s in samples:
            flat.extend(s if isinstance(s, list) else [s])
        b = len(flat)
        p, f = flat[0]["points"].shape
        batch = {
            "points": np.stack([s["points"] for s in flat]),
            "points_valid": np.stack([s["points_valid"] for s in flat]),
        }
        if "gt_boxes" in flat[0] and flat[0]["gt_boxes"] is not None:
            width = max(7, max(s["gt_boxes"].shape[1] if len(s["gt_boxes"])
                               else 7 for s in flat))
            gb = np.zeros((b, self.max_objs, width), np.float32)
            gc = np.zeros((b, self.max_objs), np.int32)
            gv = np.zeros((b, self.max_objs), bool)
            for i, s in enumerate(flat):
                n = min(len(s["gt_boxes"]), self.max_objs)
                if n:
                    gb[i, :n, :s["gt_boxes"].shape[1]] = s["gt_boxes"][:n]
                    gc[i, :n] = s.get("gt_classes", np.zeros(n, np.int32))[:n]
                    gv[i, :n] = True
            batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"] = gb, gc, gv
        for k in ("frame_id", "sequence_name", "pose", "aug_matrix_inv",
                  "aug_flip", "aug_scale", "aug_rot", "tta_name"):
            if k in flat[0]:
                batch[k] = [s.get(k) for s in flat]
        return batch

    # ------------------------------------------------------------------
    def generate_prediction_dicts(self, batch, pred_dicts):
        """Device predictions (tensors on any device, or arrays) -> reference
        output schema (dataset.py:306): one dict per sample with
        name/score/boxes_lidar/frame_id/..."""
        out = []
        boxes, scores, labels, mask = (
            torch.as_tensor(pred_dicts[k]).cpu().numpy()
            for k in ("boxes", "scores", "labels", "mask"))
        for i in range(len(boxes)):
            m = mask[i]
            out.append({
                "name": np.array([self.class_names[int(l)] for l in labels[i][m]]),
                "score": scores[i][m],
                "boxes_lidar": boxes[i][m],
                "pred_labels": labels[i][m],
                "frame_id": batch.get("frame_id", [None] * len(boxes))[i],
                "sequence_name": batch.get("sequence_name", [None] * len(boxes))[i],
                "pose": batch.get("pose", [None] * len(boxes))[i],
            })
        return out

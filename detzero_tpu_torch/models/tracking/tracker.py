"""DetZero-style offline tracker: preprocessing -> TrackManager -> PostProcessor.

Pipeline shell (reference detzero_tracker.py:4 + datasets/data_processor.py):
  * heading normalization to [-pi, pi);
  * greedy BEV-overlap dedup keeping the max-score box — removed boxes are
    RETAINED as per-frame 'drop data' so the combiner can re-merge them later
    for recall (reference overlap_box_filter, data_processor.py:97);
  * low-confidence prefilter;
  * lidar->global transform via per-frame pose;
  * forward+reverse tracking, post-processing, object-level regrouping.

Output schema mirrors the reference tracking pickle: per sequence
{'tracks': {obj_id: {'boxes_global', 'score', 'sample_idx', 'hit', 'state',
'label'}}, 'drop': per-frame dropped boxes} (models/__init__.py:51-60).

Port of detzero_tpu/models/tracking/tracker.py, unchanged but for the
imports (numpy and scipy).
"""

from __future__ import annotations

import numpy as np

from detzero_tpu_torch.models.tracking.post_process import PostProcessor
from detzero_tpu_torch.models.tracking.track_manager import TrackManager
from detzero_tpu_torch.ops import box_np


def heading_process(boxes):
    boxes = np.asarray(boxes, float)
    if len(boxes):
        boxes[:, 6] = box_np.limit_period(boxes[:, 6], 0.5, 2 * np.pi)
    return boxes


def overlap_box_filter(boxes, scores, labels, overlap_thresh: float = 0.7):
    """Greedy BEV-overlap dedup keeping the highest-score box per cluster.
    Returns (keep_mask, drop_mask)."""
    n = len(boxes)
    keep = np.ones(n, bool)
    if n < 2:
        return keep, ~keep
    order = np.argsort(-np.asarray(scores))
    bev = box_np.boxes3d_to_bev(np.asarray(boxes, float))
    ov = box_np.boxes_overlap_bev_vec(bev, bev)  # (n, n), one vectorized pass
    areas = bev[:, 2] * bev[:, 3]
    min_area = np.minimum(areas[:, None], areas[None, :])
    ratio = np.where(min_area > 0, ov / np.maximum(min_area, 1e-9), 0.0)
    same = np.asarray(labels)[:, None] == np.asarray(labels)[None, :]
    for oi, i in enumerate(order):
        if not keep[i]:
            continue
        sup = (ratio[i] > overlap_thresh) & same[i] & keep
        sup[i] = False
        # only suppress lower-scored boxes (later in `order`)
        later = np.zeros(n, bool)
        later[order[oi + 1:]] = True
        keep[sup & later] = False
    return keep, ~keep


class DetZeroTracker:
    def __init__(self, cfg=None):
        cfg = cfg or {}
        self.score_filter = float(cfg.get("LOW_SCORE_FILTER", 0.0))
        self.overlap_thresh = float(cfg.get("OVERLAP_FILTER_THRESH", 0.7))
        self.manager = TrackManager(cfg.get("TRACKING", {}))
        self.post = PostProcessor(cfg.get("POST_PROCESSING", {}))

    # ------------------------------------------------------------------
    def preprocess(self, frames):
        """frames: list of {boxes(lidar), scores, labels, pose, num_points?}.
        Returns (global-frame frames for the manager, drop data)."""
        seq, drops = [], []
        for fr in frames:
            boxes = heading_process(np.asarray(fr["boxes"], float).reshape(-1, 7))
            scores = np.asarray(fr.get("scores", np.ones(len(boxes))), float)
            labels = np.asarray(fr.get("labels", np.zeros(len(boxes), int)))
            npts = fr.get("num_points")
            conf = scores >= self.score_filter
            keep, drop = overlap_box_filter(boxes, scores, labels,
                                            self.overlap_thresh)
            keep = keep & conf
            pose = np.asarray(fr.get("pose", np.eye(4)), float)
            # drop data is retained in GLOBAL frame — combine_output
            # re-merges it with the tracker's global-frame boxes
            # (reference keeps everything global from the data_processor on)
            drop_entry = {
                "boxes": self._to_global(boxes[~keep], pose),
                "scores": scores[~keep],
                "labels": labels[~keep],
            }
            gboxes = self._to_global(boxes[keep], pose)
            entry = {
                "boxes": gboxes, "scores": scores[keep], "labels": labels[keep],
                "pose": pose,
            }
            if npts is not None:
                entry["num_points"] = np.asarray(npts)[keep]
            seq.append(entry)
            drops.append(drop_entry)
        return seq, drops

    @staticmethod
    def _to_global(boxes, pose):
        if not len(boxes):
            return boxes
        out = boxes.copy()
        out[:, :3] = boxes[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        yaw = np.arctan2(pose[1, 0], pose[0, 0])
        out[:, 6] = boxes[:, 6] + yaw
        return out

    # ------------------------------------------------------------------
    def __call__(self, frames):
        seq, drops = self.preprocess(frames)
        tracks, _used = self.manager.forward(seq)
        tracks = self.post(tracks)
        obj = {}
        for t in tracks:
            obj[int(t.tid)] = {
                "boxes_global": np.stack(t.boxes) if t.boxes else np.zeros((0, 7)),
                "score": np.asarray(t.scores),
                "sample_idx": np.asarray(t.frames, int),
                # int codes (reference convention): 0 miss / 1 tight / 2
                # loose; downstream bool casts still read "observed"
                "hit": np.asarray(t.hits, np.int32),
                "state": getattr(t, "state", "dynamic"),
                "label": t.label,
                "velocity": getattr(t, "velocities", None),
            }
        return {"tracks": obj, "drop": drops}

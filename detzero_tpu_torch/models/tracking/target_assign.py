"""GT-track <-> predicted-track assignment (reference
tracking/models/tracking_modules/target_assign.py:8 assign_track_target).

Per sequence: accumulate per-frame IoU between every predicted track and
every GT track into a trajectory-similarity matrix, Hungarian-match tracks,
and emit per-box matched flags — the supervision for refining training.

Port of detzero_tpu/models/tracking/target_assign.py (numpy and scipy).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from detzero_tpu_torch.ops import box_np


def assign_track_target(pred_tracks, gt_frames, iou_thresh: float = 0.3):
    """pred_tracks: {tid: {'boxes_global' (T,7), 'sample_idx' (T,)}};
    gt_frames: list per frame of {'boxes' (M,7), 'obj_ids' (M,)}.

    Returns {'label': {tid: {'gt_id', 'gt_boxes' (T,7), 'matched' (T,)}},
    'unlabel': [tid...]} — per-box matched flags like the reference.
    """
    gt_ids = sorted({int(i) for fr in gt_frames
                     for i in np.asarray(fr.get("obj_ids", []))})
    gid_to_col = {g: i for i, g in enumerate(gt_ids)}
    tids = list(pred_tracks)
    sim = np.zeros((len(tids), len(gt_ids)))
    per_box_iou = {}

    for ti, tid in enumerate(tids):
        tr = pred_tracks[tid]
        boxes = np.asarray(tr["boxes_global"], float)
        frames = np.asarray(tr["sample_idx"], int)
        ious = np.zeros((len(boxes), len(gt_ids)))
        for bi, (b, f) in enumerate(zip(boxes, frames)):
            if f >= len(gt_frames):
                continue
            g = np.asarray(gt_frames[f].get("boxes", np.zeros((0, 7)))).reshape(-1, 7)
            ids = np.asarray(gt_frames[f].get("obj_ids", []))
            if not len(g):
                continue
            iou = box_np.boxes_iou3d(b[None, :7], g)[0]
            for k, gid in enumerate(ids):
                ious[bi, gid_to_col[int(gid)]] = iou[k]
        per_box_iou[tid] = ious
        sim[ti] = ious.sum(axis=0)

    out = {"label": {}, "unlabel": []}
    if len(tids) and len(gt_ids):
        cost = -sim
        r, c = linear_sum_assignment(cost)
        assigned = {}
        for ti, gi in zip(r, c):
            if sim[ti, gi] > 0:
                assigned[tids[ti]] = gi
        for tid in tids:
            if tid in assigned:
                gi = assigned[tid]
                tr = pred_tracks[tid]
                frames = np.asarray(tr["sample_idx"], int)
                gid = gt_ids[gi]
                gt_boxes = np.zeros((len(frames), 7), np.float32)
                matched = per_box_iou[tid][:, gi] >= iou_thresh
                for bi, f in enumerate(frames):
                    if f >= len(gt_frames):
                        continue
                    ids = np.asarray(gt_frames[f].get("obj_ids", []))
                    sel = np.where(ids == gid)[0]
                    if len(sel):
                        gt_boxes[bi] = np.asarray(
                            gt_frames[f]["boxes"])[sel[0], :7]
                out["label"][tid] = {"gt_id": gid, "gt_boxes": gt_boxes,
                                     "matched": matched}
            else:
                out["unlabel"].append(tid)
    else:
        out["unlabel"] = tids
    return out


def track_recall(pred_tracks, gt_frames, iou_thresholds=(0.7, 0.5, 0.5),
                 class_of=None, match_rate_cutoffs=(0.5,)):
    """Tracklet-level recall/precision (reference utils/track_recall.py:19):
    a GT trajectory counts as recalled when the fraction of its boxes matched
    by one predicted track at the class IoU threshold exceeds the cutoff."""
    assign = assign_track_target(pred_tracks, gt_frames, iou_thresh=0.0)
    gt_len = {}
    for fr in gt_frames:
        for gid in np.asarray(fr.get("obj_ids", [])):
            gt_len[int(gid)] = gt_len.get(int(gid), 0) + 1
    results = {}
    for cutoff in match_rate_cutoffs:
        tp = 0
        for tid, lab in assign["label"].items():
            thr = iou_thresholds[0] if class_of is None else \
                iou_thresholds[int(class_of(tid))]
            boxes = np.asarray(pred_tracks[tid]["boxes_global"], float)
            ious = np.array([
                box_np.boxes_iou3d(b[None, :7], lab["gt_boxes"][i][None])[0, 0]
                if lab["gt_boxes"][i].any() else 0.0
                for i, b in enumerate(boxes)
            ])
            rate = (ious >= thr).sum() / max(gt_len.get(lab["gt_id"], 1), 1)
            if rate >= cutoff:
                tp += 1
        n_gt = len(gt_len)
        n_pred = len(pred_tracks)
        results[cutoff] = {
            "recall": tp / max(n_gt, 1),
            "precision": tp / max(n_pred, 1),
            "tp": tp, "num_gt_tracks": n_gt, "num_pred_tracks": n_pred,
        }
    return results

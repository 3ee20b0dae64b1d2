"""Detection-to-track data association.

Re-derives the reference's two-stage association (data_association.py:62):
stage 1 matches confident, well-observed detections against all tracks under
a tight per-class threshold; stage 2 matches the leftovers against the
still-unmatched tracks under a loose threshold. Unmatched low-confidence
detections are dropped (they never spawn tracks). Assignment is Hungarian
(scipy) on a class-gated affinity matrix.

Affinities come from the NumPy rotated-IoU oracle (ops/box_np) — exact
polygon clipping; N·M here is tens, not thousands, so host compute is fine
(a device path via ops/iou3d drops in for large batches).

Port of detzero_tpu/models/tracking/association.py, unchanged but for the
imports (numpy and scipy).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from detzero_tpu_torch.ops import box_np

BIG_COST = 1e5


def affinity_matrix(det_boxes, trk_boxes, metric: str = "iou_bev"):
    """(N,7) x (M,7) -> (N,M) affinity in [0,1]-ish (higher = closer)."""
    if len(det_boxes) == 0 or len(trk_boxes) == 0:
        return np.zeros((len(det_boxes), len(trk_boxes)))
    if metric == "iou_bev":
        return box_np.boxes_iou_bev_vec(
            box_np.boxes3d_to_bev(np.asarray(det_boxes)),
            box_np.boxes3d_to_bev(np.asarray(trk_boxes)),
        )
    if metric == "iou_3d":
        return box_np.boxes_iou3d(det_boxes, trk_boxes)
    if metric == "giou_3d":
        return (box_np.boxes_giou3d(det_boxes, trk_boxes) + 1.0) / 2.0
    if metric == "euclidean":
        d = np.linalg.norm(
            np.asarray(det_boxes)[:, None, :2] - np.asarray(trk_boxes)[None, :, :2],
            axis=-1,
        )
        return 1.0 / (1.0 + d)
    raise NotImplementedError(metric)


def hungarian_match(affinity, class_gate=None, thresholds=None, det_labels=None):
    """Hungarian over cost = 1 - affinity with sub-threshold pairs masked.

    thresholds: per-class affinity floor indexed by det label (or scalar).
    Returns list of (det_idx, trk_idx).
    """
    if affinity.size == 0:
        return []
    aff = affinity.copy()
    if class_gate is not None:
        aff[~class_gate] = 0.0
    if thresholds is not None:
        if np.isscalar(thresholds):
            floor = np.full(aff.shape[0], float(thresholds))
        else:
            floor = np.asarray(thresholds)[np.asarray(det_labels)]
        aff[aff < floor[:, None]] = 0.0
    cost = 1.0 - aff
    cost[aff <= 0.0] = BIG_COST
    rows, cols = linear_sum_assignment(cost)
    return [(int(r), int(c)) for r, c in zip(rows, cols) if cost[r, c] < BIG_COST]


def _class_gate(det_labels, trk_labels):
    return np.asarray(det_labels)[:, None] == np.asarray(trk_labels)[None, :]


def associate_one_stage(det_boxes, det_labels, trk_boxes, trk_labels,
                        thresholds, metric="iou_bev"):
    aff = affinity_matrix(det_boxes, trk_boxes, metric)
    gate = _class_gate(det_labels, trk_labels)
    matches = hungarian_match(aff, gate, thresholds, det_labels)
    matched_d = {d for d, _ in matches}
    matched_t = {t for _, t in matches}
    unmatched_d = [i for i in range(len(det_boxes)) if i not in matched_d]
    unmatched_t = [i for i in range(len(trk_boxes)) if i not in matched_t]
    return matches, unmatched_d, unmatched_t


def associate_two_stage(det_boxes, det_labels, det_scores, det_npoints,
                        trk_boxes, trk_labels, *, tight_thresh, loose_thresh,
                        score_thresh=0.5, min_points=5, metric="iou_bev",
                        parity=True):
    """Two-stage association (reference two_stage, data_association.py:62).

    Returns (matches, match_stages, new_track_det_idx, unmatched_trk_idx,
    dropped_det_idx); match_stages[i] is 0 for a tight (stage-1) match and
    1 for a loose (stage-2) match — stage-2 matches must not update the KF
    state (kalman_filter.py:120-122).

    parity=True (default): the stage-2 candidate pool is ONLY the weak
    detections, exactly like the reference (data_association.py:93-95) —
    unmatched STRONG detections go straight to spawning. parity=False also
    offers stage-1 leftovers to stage 2 (round-1 behavior; recovers a few
    borderline matches at the cost of reference fidelity).
    """
    n = len(det_boxes)
    det_boxes = np.asarray(det_boxes).reshape(n, -1)
    if len(trk_boxes) == 0 and parity:
        # reference early-return (data_association.py:74-76): with no live
        # tracks, EVERY detection passing the point threshold spawns — the
        # score threshold is not consulted (so weak frame-0 dets birth
        # tracks); the rest are dropped.
        enough_pts = np.asarray(det_npoints) >= min_points
        new_tracks = [int(i) for i in np.flatnonzero(enough_pts)]
        dropped = [int(i) for i in np.flatnonzero(~enough_pts)]
        return [], [], new_tracks, [], dropped
    strong = (np.asarray(det_scores) >= score_thresh) & (
        np.asarray(det_npoints) >= min_points
    )
    strong_idx = np.where(strong)[0]
    weak_idx = np.where(~strong)[0]

    m1, un_d1, un_t = associate_one_stage(
        det_boxes[strong_idx], np.asarray(det_labels)[strong_idx],
        trk_boxes, trk_labels, tight_thresh, metric,
    )
    matches = [(int(strong_idx[d]), t) for d, t in m1]
    stages = [0] * len(matches)
    unmatched_strong = [int(strong_idx[d]) for d in un_d1]

    # stage 2 vs unmatched tracks under the loose threshold
    if parity:
        stage2_d = np.asarray(weak_idx, int)
        strong_leftover = list(unmatched_strong)
    else:
        stage2_d = np.array(unmatched_strong + [int(i) for i in weak_idx], int)
        strong_leftover = []
    un_t = np.asarray(un_t, int)
    if len(stage2_d) and len(un_t):
        trk_boxes = np.asarray(trk_boxes).reshape(len(trk_labels), -1)
        m2, un_d2, un_t2 = associate_one_stage(
            det_boxes[stage2_d], np.asarray(det_labels)[stage2_d],
            trk_boxes[un_t], np.asarray(trk_labels)[un_t], loose_thresh, metric,
        )
        matches += [(int(stage2_d[d]), int(un_t[t])) for d, t in m2]
        stages += [1] * len(m2)
        leftover = strong_leftover + [int(stage2_d[d]) for d in un_d2]
        unmatched_t = [int(un_t[t]) for t in un_t2]
    else:
        leftover = strong_leftover + [int(i) for i in stage2_d]
        unmatched_t = [int(t) for t in un_t]

    # only strong leftovers spawn tracks; weak leftovers are dropped
    strong_set = set(int(i) for i in strong_idx)
    new_tracks = [i for i in leftover if i in strong_set]
    dropped = [i for i in leftover if i not in strong_set]
    return matches, stages, new_tracks, unmatched_t, dropped

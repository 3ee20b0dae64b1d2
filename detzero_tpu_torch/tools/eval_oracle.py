"""Clean-room Waymo detection-metric oracle (port of tools/eval_oracle.py,
the same code on the port's ops/box_np).

A SECOND, independently structured implementation of the Waymo AP/APH
protocol, written directly from the metric op's documented algorithm
(waymo_open_dataset metrics/ops semantics as configured by the reference's
detection/detzero_det/datasets/waymo/waymo_eval_detection.py:87-204):

  * 101 score cutoffs 0.00 .. 0.99, 1.00; predictions with
    score >= cutoff survive; the Hungarian matcher re-runs from scratch
    at EVERY cutoff (no prefix sharing, unlike pipeline/evaluator.py);
  * per-frame Hungarian assignment maximizes total IoU, pairs below the
    class IoU threshold are invalid;
  * difficulty L1: GTs of difficulty 2 are IGNORE targets — a prediction
    matched to one is neither TP nor FP, and the GT is not counted in
    num_gt; L2 counts both difficulties (cumulative);
  * APH weights each TP's precision contribution by heading accuracy
    1 - |wrap(dtheta)| / pi; the recall axis stays unweighted;
  * AP integrates the (precision, recall) operating points in ascending
    recall with each new point credited precision * min(recall_gain, 0.05)
    (the op's max_recall_delta cap).

The port's pipeline/evaluator.py's waymo101 mode implements the same
protocol with a shared-prefix optimization and vectorized accumulation;
tests/test_torch_utils.py holds it to this oracle on randomized scenes, as
tests/test_eval_oracle_ab.py holds the reference's evaluator to the
reference's oracle.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from detzero_tpu_torch.ops import box_np

ORACLE_IOU = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
CUTOFFS = [i / 100.0 for i in range(100)] + [1.0]
MAX_RECALL_DELTA = 0.05


def _wrap_heading_acc(dt):
    dt = abs(float(dt)) % (2.0 * np.pi)
    if dt > np.pi:
        dt = 2.0 * np.pi - dt
    return 1.0 - dt / np.pi


def _hungarian(pred, gt, thresh):
    """Max-IoU assignment; returns list of (pred_i, gt_i, iou)."""
    if len(pred) == 0 or len(gt) == 0:
        return []
    iou = box_np.boxes_iou3d(np.asarray(pred)[:, :7], np.asarray(gt)[:, :7])
    gain = np.where(iou >= thresh, iou, 0.0)
    rows, cols = linear_sum_assignment(-gain)
    return [(int(r), int(c), float(iou[r, c]))
            for r, c in zip(rows, cols) if iou[r, c] >= thresh]


def _frame_events(pred_boxes, pred_scores, gt_boxes, gt_difficulty, level,
                  thresh, cutoff):
    """One frame at one cutoff -> (tp, heading_sum, fp)."""
    keep = [i for i in range(len(pred_scores)) if pred_scores[i] >= cutoff]
    pb = [pred_boxes[i] for i in keep]
    tp = 0
    hsum = 0.0
    fp = 0
    matches = _hungarian(pb, gt_boxes, thresh)
    matched_preds = set()
    for pi, gi, _ in matches:
        matched_preds.add(pi)
        if level == 1 and gt_difficulty[gi] > 1:
            continue  # ignore target: neither TP nor FP
        tp += 1
        hsum += _wrap_heading_acc(pb[pi][6] - gt_boxes[gi][6])
    for pi in range(len(pb)):
        if pi not in matched_preds:
            fp += 1
    return tp, hsum, fp


def _integrate(points):
    """points: list of (precision, heading_precision, recall) in ASCENDING
    cutoff order; credited walking the curve from the highest cutoff down
    (recall non-decreasing), each new recall gain capped at 0.05.

    Tie convention (both implementations agree, documented): when several
    cutoffs share a recall value, the HIGHEST cutoff's precision (the first
    point reached tracing the curve) takes the credit — later equal-recall
    points add zero gain.  Sorting by recall instead would hand the credit
    to the lowest cutoff and shifts AP by ~1e-2 on realistic scenes."""
    ap = aph = 0.0
    covered = 0.0
    for p, hp, r in reversed(points):
        if r > covered:
            gain = min(r - covered, MAX_RECALL_DELTA)
            ap += gain * p
            aph += gain * hp
            covered = r
    return ap, aph


def oracle_evaluate(preds, gts, class_names=("Vehicle", "Pedestrian",
                                             "Cyclist"), iou=None):
    """preds/gts: per-frame lists of dicts with keys 'boxes' (N,7+),
    'scores' (preds), 'names', and gts additionally 'difficulty' (1/2).
    Returns {class: {AP_L1, APH_L1, AP_L2, APH_L2}} — same contract as
    pipeline.evaluator.evaluate_detection's waymo101 core."""
    iou = iou or ORACLE_IOU
    out = {}
    for cls in class_names:
        thresh = iou[cls]
        # per-frame class-filtered views
        frames = []
        for pf, gf in zip(preds, gts):
            psel = [i for i in range(len(pf["names"])) if pf["names"][i] == cls]
            gsel = [i for i in range(len(gf["names"])) if gf["names"][i] == cls]
            frames.append((
                [np.asarray(pf["boxes"][i], float) for i in psel],
                [float(pf["scores"][i]) for i in psel],
                [np.asarray(gf["boxes"][i], float) for i in gsel],
                [int(gf["difficulty"][i]) for i in gsel],
            ))
        res = {}
        for level in (1, 2):
            ngt = sum(
                sum(1 for d in f[3] if level == 2 or d <= 1)
                for f in frames)
            if ngt == 0:
                res[f"AP_L{level}"] = res[f"APH_L{level}"] = 0.0
                continue
            points = []
            for cutoff in CUTOFFS:
                tp = fp = 0
                hsum = 0.0
                for pb, ps, gb, gd in frames:
                    t, h, f_ = _frame_events(pb, ps, gb, gd, level,
                                             thresh, cutoff)
                    tp += t
                    hsum += h
                    fp += f_
                denom = tp + fp
                prec = tp / denom if denom else 0.0
                hprec = hsum / denom if denom else 0.0
                points.append((prec, hprec, tp / ngt))
            ap, aph = _integrate(points)
            res[f"AP_L{level}"] = ap
            res[f"APH_L{level}"] = aph
        out[cls] = res
    return out

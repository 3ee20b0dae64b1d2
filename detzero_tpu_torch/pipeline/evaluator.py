"""Self-contained detection/tracking metrics (Waymo protocol).

The reference wraps the waymo_open_dataset TF1 metric ops
(evaluator/detzero_eval.py, waymo_eval_detection.py, waymo_eval_tracking.py);
that tooling isn't available here, so this module implements the same
protocol natively:

  * AP / APH per class with Hungarian matching at IoU 0.7 (Vehicle) /
    0.5 (Pedestrian, Cyclist) — APH weights each TP by heading accuracy
    max(0, 1 - |Δθ̃| / π);
  * L1/L2 difficulty: L2 = GT with <= 5 lidar points (the reference
    recomputes difficulty the same way, waymo_eval_detection.py:39-42) —
    L2 metrics include BOTH difficulties (Waymo semantics);
  * range breakdowns [0,30) / [30,50) / [50,+inf);
  * CLEAR-MOT tracking metrics (MOTA / MOTP / miss / mismatch / FP) matching
    waymo_eval_tracking.py's reported quantities.

Two PR-integration modes (``ap_mode`` argument of :func:`evaluate_detection`):

  * ``"envelope"`` (default): full interpolated-envelope area over every
    operating point — fast, one Hungarian match per frame.
  * ``"waymo101"``: the reference TF op's protocol — the PR curve is
    evaluated at the 101 fixed score cutoffs 0.00, 0.01, ..., 0.99, 1.00
    (detection/detzero_det/datasets/waymo/waymo_eval_detection.py:128-130),
    with the Hungarian matching re-run per cutoff on the score-filtered
    prediction set, and integrated with the op's capped-recall-delta
    rectangle sum (each operating point credits precision * min(recall
    gained, 0.05)). Golden-fixture tests with analytically-known AP/APH
    pin both modes (tests/test_evaluator_golden.py), including the op's
    signature behavior that a perfect detector with all-equal scores
    scores only ~0.05 AP under waymo101.

Port of detzero_tpu/pipeline/evaluator.py, unchanged but for the import
of the port's own box_np.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from detzero_tpu_torch.ops import box_np

DEFAULT_IOU = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
RANGES = ((0, 30), (30, 50), (50, np.inf))


def _match_frame(pred_boxes, pred_scores, gt_boxes, iou_thresh):
    """Hungarian max-IoU matching. Returns (pred_idx, gt_idx, iou) arrays."""
    if not len(pred_boxes) or not len(gt_boxes):
        return np.zeros(0, int), np.zeros(0, int), np.zeros(0)
    iou = box_np.boxes_iou3d(pred_boxes[:, :7], gt_boxes[:, :7])
    cost = 1.0 - iou
    cost[iou < iou_thresh] = 1e6
    r, c = linear_sum_assignment(cost)
    ok = cost[r, c] < 1e6
    return r[ok], c[ok], iou[r[ok], c[ok]]


def _heading_accuracy(pred_heading, gt_heading):
    d = np.abs(pred_heading - gt_heading) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return np.maximum(0.0, 1.0 - d / np.pi)


def _average_precision(tp_flags, fp_flags, scores, num_gt, prec_weights=None):
    """AP via interpolated precision envelope.

    tp_flags: 0/1 match indicators (define the recall axis).
    prec_weights: optional per-prediction precision-numerator weights
    (heading accuracy for APH — the recall axis stays UNWEIGHTED per the
    Waymo protocol; only p(r) is replaced by h(r))."""
    if num_gt == 0:
        return 0.0
    if not len(scores):
        return 0.0
    order = np.argsort(-scores)
    tp = np.cumsum(tp_flags[order])
    fp = np.cumsum(fp_flags[order])
    recall = tp / num_gt
    num = np.cumsum(prec_weights[order]) if prec_weights is not None else tp
    precision = num / np.maximum(tp + fp, 1e-9)
    # precision envelope + trapezoid-free step integration
    prec = np.maximum.accumulate(precision[::-1])[::-1]
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[prec[0] if len(prec) else 0.0], prec])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


# 101 fixed score cutoffs of the reference metric op
# (waymo_eval_detection.py:128-130).
WAYMO_SCORE_CUTOFFS = np.concatenate([np.arange(100) * 0.01, [1.0]])


def _frame_match_stats(pb, ps, gb, hard, iou_thresh):
    """Single-frame matching → per-prediction (matched, heading_acc, hard_gt)."""
    pi, gi, _ = _match_frame(pb, ps, gb, iou_thresh)
    matched = np.zeros(len(pb), bool)
    matched[pi] = True
    hacc = np.zeros(len(pb))
    gt_hard = np.zeros(len(pb), bool)
    if len(pi):
        hacc[pi] = _heading_accuracy(pb[pi, 6], gb[gi, 6])
        gt_hard[pi] = hard[gi]
    return matched, hacc, gt_hard


def _accumulate_cutoff_stats(frames, iou_thresh, cutoffs, acc):
    """Per-cutoff TP/heading-sum/FP accumulation with exact re-matching.

    The reference metric op filters predictions by ``score >= cutoff`` and
    re-runs the Hungarian matcher per cutoff; since the filtered set is a
    prefix of the score-sorted predictions, only distinct prefix lengths
    need a fresh match.

    acc: dict with 'tp','ha','fp' per level -> (n_cutoffs,) arrays, mutated.
    """
    for pb, ps, gb, hard in frames:
        order = np.argsort(-ps)
        pb, ps = pb[order], ps[order]
        # prefix length per cutoff: number of scores >= cutoff
        ks = np.searchsorted(-ps, -cutoffs, side="right")
        for k in np.unique(ks):
            if k == 0:
                continue
            matched, hacc, gt_hard = _frame_match_stats(
                pb[:k], ps[:k], gb, hard, iou_thresh)
            sel = ks == k
            tp2 = float(matched.sum())
            acc["L2"]["tp"][sel] += tp2
            acc["L2"]["ha"][sel] += float(hacc[matched].sum())
            acc["L2"]["fp"][sel] += k - tp2
            easy_tp = matched & ~gt_hard
            tp1 = float(easy_tp.sum())
            acc["L1"]["tp"][sel] += tp1
            acc["L1"]["ha"][sel] += float(hacc[easy_tp].sum())
            acc["L1"]["fp"][sel] += k - tp2  # hard-GT matches are ignored


def _integrate_pr_capped(precision, recall, max_recall_delta=0.05):
    """The metric op's capped-recall-delta rectangle sum.

    Points arrive ordered by increasing score cutoff (non-increasing
    recall); we walk them in DESCENDING cutoff order (recall growing from
    0) and credit each operating point with
    ``precision_i * min(recall_i - best_recall_so_far, max_recall_delta)``.
    The cap is the op's guard against sparse operating points: recall
    gained in one >0.05 jump is only credited 0.05, which is why
    degenerate score distributions (all scores equal) evaluate to ~0.05
    AP under the real Waymo metric no matter how good the boxes are.
    Rectangle rule, not trapezoid (ADVICE r1: the old gap-bridged
    trapezoid only approximated this sum).
    """
    ap = 0.0
    last_r = 0.0
    for p, r in zip(precision[::-1], recall[::-1]):
        if r > last_r:
            ap += min(float(r) - last_r, max_recall_delta) * float(p)
            last_r = float(r)
    return ap


def _ap_waymo101(frames, iou_thresh, num_gt, cutoffs=None):
    """(AP, APH) for one (class, level-partition) via 101-cutoff sampling."""
    cutoffs = WAYMO_SCORE_CUTOFFS if cutoffs is None else cutoffs
    n = len(cutoffs)
    acc = {lvl: {k: np.zeros(n) for k in ("tp", "ha", "fp")}
           for lvl in ("L1", "L2")}
    _accumulate_cutoff_stats(frames, iou_thresh, cutoffs, acc)
    out = {}
    for lvl in ("L1", "L2"):
        a = acc[lvl]
        denom = np.maximum(a["tp"] + a["fp"], 1e-9)
        ng = max(num_gt[lvl], 1e-9)
        if num_gt[lvl] == 0:
            out[f"AP_{lvl}"] = out[f"APH_{lvl}"] = 0.0
            continue
        # APH: the RECALL axis stays unweighted; only the precision
        # numerator is heading-weighted ("each TP weighted by heading
        # accuracy" — Waymo protocol; h(r) replaces p(r) on the same r)
        out[f"AP_{lvl}"] = _integrate_pr_capped(a["tp"] / denom, a["tp"] / ng)
        out[f"APH_{lvl}"] = _integrate_pr_capped(a["ha"] / denom, a["tp"] / ng)
    return out


def evaluate_detection(preds, gts, class_names=("Vehicle", "Pedestrian",
                                                "Cyclist"),
                       iou_thresholds=None, with_range_breakdown=False,
                       ap_mode="envelope"):
    """preds/gts: lists (per frame) of dicts.
        pred: {'boxes_lidar' (N, 7+), 'score' (N,), 'name' (N,) str}
        gt:   {'gt_boxes' (M, 7), 'name' (M,), 'num_points' (M,) optional,
               'difficulty' (M,) optional (2 = hard)}
    ap_mode: 'envelope' (interpolated envelope, single match per frame) or
        'waymo101' (exact 101-score-cutoff sampling with per-cutoff
        re-matching — the reference TF op's protocol; slower).
    Returns {class: {'AP_L1', 'APH_L1', 'AP_L2', 'APH_L2', ...}} plus 'mean'.
    """
    if ap_mode not in ("envelope", "waymo101"):
        raise ValueError(f"unknown ap_mode {ap_mode!r}")
    iou_thresholds = iou_thresholds or DEFAULT_IOU
    results = {}
    range_of = lambda b: np.linalg.norm(b[:, :2], axis=1)

    for cls in class_names:
        frames = []  # (pb, ps, gb, hard) per frame
        num_gt = {"L1": 0, "L2": 0}
        rng_gt = {i: 0 for i in range(len(RANGES))}

        for pred, gt in zip(preds, gts):
            pm = np.asarray(pred.get("name", [])) == cls
            pb = np.asarray(pred.get("boxes_lidar",
                                     np.zeros((0, 7))))[pm].reshape(-1, 7) \
                if pm.any() else np.zeros((0, 7))
            ps = np.asarray(pred.get("score", []))[pm] if pm.any() else np.zeros(0)
            gm = np.asarray(gt.get("name", [])) == cls
            gb = np.asarray(gt.get("gt_boxes", np.zeros((0, 7))))[gm].reshape(-1, 7) \
                if gm.any() else np.zeros((0, 7))
            # per-GT metadata must be CLASS-MASKED like the boxes (found by
            # the clean-room A/B oracle, tests/test_eval_oracle_ab.py — the
            # old [:len(gb)] slice misaligned difficulty/num_points with the
            # filtered boxes whenever classes interleave)
            n_all = len(gm)
            npts_all = np.asarray(gt.get("num_points", np.full(n_all, 100)))
            if len(npts_all) < n_all:  # short metadata: assume easy
                npts_all = np.concatenate(
                    [npts_all, np.full(n_all - len(npts_all), 100)])
            diff_all = np.asarray(gt.get("difficulty", np.ones(n_all)))
            if len(diff_all) < n_all:
                diff_all = np.concatenate(
                    [diff_all, np.ones(n_all - len(diff_all))])
            npts = npts_all[gm] if gm.any() else np.zeros(0)
            diff = diff_all[gm] if gm.any() else np.zeros(0)
            hard = (npts <= 5) | (diff >= 2)

            frames.append((pb, ps, gb, hard))
            num_gt["L2"] += len(gb)
            num_gt["L1"] += int((~hard).sum())
            if with_range_breakdown:
                centers_r = range_of(gb) if len(gb) else np.zeros(0)
                for ri, (lo, hi) in enumerate(RANGES):
                    rng_gt[ri] += int(((centers_r >= lo) & (centers_r < hi)).sum())

        if ap_mode == "waymo101":
            out = _ap_waymo101(frames, iou_thresholds[cls], num_gt)
            match_cache = None
        else:
            match_cache = [_frame_match_stats(pb, ps, gb, hard,
                                              iou_thresholds[cls])
                           for pb, ps, gb, hard in frames]
            recs = {"L1": [], "L2": []}  # (score, tp_w_ap, tp_w_aph, fp)
            for (pb, ps, gb, hard), (matched_p, hacc, gt_hard) in zip(
                    frames, match_cache):
                for s, m, h, is_hard in zip(ps, matched_p, hacc, gt_hard):
                    # L2 counts everything; L1 ignores hard GT matches
                    recs["L2"].append((s, float(m), h * m, float(~m)))
                    if m and is_hard:
                        continue  # neither TP nor FP at L1 (hard-GT match)
                    recs["L1"].append((s, float(m), h * m, float(~m)))
            out = {}
            for lvl in ("L1", "L2"):
                if recs[lvl]:
                    arr = np.asarray(recs[lvl])
                    out[f"AP_{lvl}"] = _average_precision(
                        arr[:, 1], arr[:, 3], arr[:, 0], num_gt[lvl])
                    out[f"APH_{lvl}"] = _average_precision(
                        arr[:, 1], arr[:, 3], arr[:, 0], num_gt[lvl],
                        prec_weights=arr[:, 2])
                else:
                    out[f"AP_{lvl}"] = out[f"APH_{lvl}"] = 0.0

        if with_range_breakdown:
            for ri, (lo, hi) in enumerate(RANGES):
                rng_recs = []
                rng_frames = []
                for fi, (pb, ps, gb, hard) in enumerate(frames):
                    gsel = (range_of(gb) >= lo) & (range_of(gb) < hi) \
                        if len(gb) else np.zeros(0, bool)
                    psel = (range_of(pb) >= lo) & (range_of(pb) < hi) \
                        if len(pb) else np.zeros(0, bool)
                    if ap_mode == "waymo101":
                        rng_frames.append((pb[psel], ps[psel], gb[gsel],
                                           hard[gsel]))
                    else:
                        matched_p, hacc, _ = match_cache[fi]
                        for k in np.flatnonzero(psel):
                            rng_recs.append(
                                (ps[k], float(matched_p[k]),
                                 hacc[k] * matched_p[k], float(~matched_p[k])))
                if ap_mode == "waymo101":
                    rout = _ap_waymo101(
                        rng_frames, iou_thresholds[cls],
                        {"L1": rng_gt[ri], "L2": rng_gt[ri]})
                    out[f"AP_[{lo},{hi})"] = rout["AP_L2"]
                elif rng_recs:
                    arr = np.asarray(rng_recs)
                    out[f"AP_[{lo},{hi})"] = _average_precision(
                        arr[:, 1], arr[:, 3], arr[:, 0], rng_gt[ri])
                else:
                    out[f"AP_[{lo},{hi})"] = 0.0
        results[cls] = out

    results["mean"] = {
        k: float(np.mean([results[c][k] for c in class_names]))
        for k in ("AP_L1", "APH_L1", "AP_L2", "APH_L2")
    }
    return results


# ----------------------------------------------------------------------
def _clear_mot_counters(pred_frames, gt_frames, iou_thresh):
    """Raw CLEAR-MOT counters over one sequence (summable across
    sequences)."""
    misses = fps = mismatches = matches = 0
    iou_sum = 0.0
    num_gt = 0
    last_match = {}  # gt_id -> pred_id
    for pf, gf in zip(pred_frames, gt_frames):
        pb = np.asarray(pf["boxes"], float).reshape(-1, 7)
        gb = np.asarray(gf["boxes"], float).reshape(-1, 7)
        pids = np.asarray(pf["obj_ids"])
        gids = np.asarray(gf["obj_ids"])
        num_gt += len(gb)
        pi, gi, iou = _match_frame(pb, np.ones(len(pb)), gb, iou_thresh)
        matches += len(pi)
        iou_sum += float(iou.sum())
        misses += len(gb) - len(gi)
        fps += len(pb) - len(pi)
        for p, g in zip(pi, gi):
            gid = gids[g]
            pid = pids[p]
            if gid in last_match and last_match[gid] != pid:
                mismatches += 1
            last_match[gid] = pid
    return {"misses": misses, "fps": fps, "mismatches": mismatches,
            "matches": matches, "iou_sum": iou_sum, "num_gt": num_gt}


def _clear_mot_metrics(c):
    mota = 1.0 - (c["misses"] + c["fps"] + c["mismatches"]) / max(c["num_gt"], 1)
    motp = c["iou_sum"] / max(c["matches"], 1)
    return {"MOTA": mota, "MOTP": motp,
            "miss": c["misses"] / max(c["num_gt"], 1),
            "mismatch": c["mismatches"] / max(c["num_gt"], 1),
            "fp": c["fps"] / max(c["num_gt"], 1), "num_gt": c["num_gt"]}


def evaluate_tracking(pred_frames, gt_frames, iou_thresh=0.5):
    """CLEAR-MOT over one sequence.

    pred_frames: list of {'boxes' (N,7), 'obj_ids' (N,)};
    gt_frames: list of {'boxes' (M,7), 'obj_ids' (M,)}.
    Returns dict(MOTA, MOTP, miss, mismatch, fp, num_gt).
    """
    return _clear_mot_metrics(
        _clear_mot_counters(pred_frames, gt_frames, iou_thresh))


def evaluate_tracking_by_class(sequences, class_names=("Vehicle",
                                                       "Pedestrian",
                                                       "Cyclist"),
                               iou_thresholds=None):
    """Per-OBJECT_TYPE CLEAR-MOT aggregated over sequences — the quantities
    waymo_eval_tracking.py reports (MOTA/MOTP/MISS/MISMATCH/FP per class).

    sequences: list of (pred_frames, gt_frames) pairs where frames carry an
    additional 'name' (N,) str array next to 'boxes'/'obj_ids'.
    Matching IoU per class follows the detection thresholds (0.7/0.5/0.5).
    """
    iou_thresholds = iou_thresholds or DEFAULT_IOU
    results = {}
    for cls in class_names:
        agg = {"misses": 0, "fps": 0, "mismatches": 0, "matches": 0,
               "iou_sum": 0.0, "num_gt": 0}
        for pred_frames, gt_frames in sequences:
            def _filt(frames):
                out = []
                for fr in frames:
                    names = np.asarray(fr.get("name", []))
                    m = names == cls if len(names) else np.zeros(
                        len(np.asarray(fr["boxes"]).reshape(-1, 7)), bool)
                    out.append({
                        "boxes": np.asarray(fr["boxes"],
                                            float).reshape(-1, 7)[m],
                        "obj_ids": np.asarray(fr["obj_ids"])[m],
                    })
                return out
            c = _clear_mot_counters(_filt(pred_frames), _filt(gt_frames),
                                    iou_thresholds.get(cls, 0.5))
            for k in agg:
                agg[k] += c[k]
        results[cls] = _clear_mot_metrics(agg)
    results["mean"] = {
        k: float(np.mean([results[c][k] for c in class_names]))
        for k in ("MOTA", "MOTP", "miss", "mismatch", "fp")
    }
    return results


def format_results_table(results):
    """Tabulated report like detzero_eval.py:140-260."""
    lines = []
    keys = None
    for cls, vals in results.items():
        if keys is None:
            keys = sorted(vals)
            lines.append("class      " + "  ".join(f"{k:>10}" for k in keys))
        lines.append(f"{cls:<10} " + "  ".join(f"{vals.get(k, 0.0):10.4f}"
                                               for k in keys))
    return "\n".join(lines)

"""Tracklet-recall and CLEAR-MOT eval CLI (port of tools/eval_track.py;
reference tracking/tools/eval_track.py):

    python -m detzero_tpu_torch.tools.eval_track \
        --track_path tracking-val-<stamp>.pkl --gt_path gt.pkl

`main(argv)` runs in-process and returns {metric: mean over sequences}
for the metrics that have a value (recall, precision, MOTA, MOTP).
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def main(argv=None):
    from detzero_tpu_torch.core.logger import create_logger
    from detzero_tpu_torch.models.tracking.target_assign import track_recall
    from detzero_tpu_torch.pipeline.evaluator import evaluate_tracking

    p = argparse.ArgumentParser("tracklet recall + CLEAR-MOT eval")
    p.add_argument("--track_path", required=True)
    p.add_argument("--gt_path", required=True,
                   help="pickle {seq: [per-frame {'boxes','obj_ids'}]}")
    p.add_argument("--iou", type=float, nargs=3, default=[0.7, 0.5, 0.5])
    args = p.parse_args(argv)
    logger = create_logger()

    with open(args.track_path, "rb") as f:
        tracking = pickle.load(f)
    with open(args.gt_path, "rb") as f:
        gt = pickle.load(f)

    agg = {"recall": [], "precision": [], "MOTA": [], "MOTP": []}
    for seq, tr in tracking.items():
        if seq not in gt:
            continue
        rec = track_recall(tr["tracks"], gt[seq], iou_thresholds=args.iou)
        cutoff = sorted(rec)[0]
        agg["recall"].append(rec[cutoff]["recall"])
        agg["precision"].append(rec[cutoff]["precision"])
        # frame-level CLEAR-MOT
        n_frames = len(gt[seq])
        frames = [{"boxes": [], "obj_ids": []} for _ in range(n_frames)]
        for tid, t in tr["tracks"].items():
            for b, f in zip(t["boxes_global"], t["sample_idx"]):
                if f < n_frames:
                    frames[f]["boxes"].append(b[:7])
                    frames[f]["obj_ids"].append(tid)
        for fr in frames:
            fr["boxes"] = (np.stack(fr["boxes"]) if fr["boxes"]
                           else np.zeros((0, 7)))
            fr["obj_ids"] = np.asarray(fr["obj_ids"])
        mot = evaluate_tracking(frames, gt[seq])
        agg["MOTA"].append(mot["MOTA"])
        agg["MOTP"].append(mot["MOTP"])
    out = {}
    for k, v in agg.items():
        if v:
            out[k] = float(np.mean(v))
            logger.info(f"{k}: {np.mean(v):.4f} over {len(v)} sequences")
    return out


if __name__ == "__main__":
    main()

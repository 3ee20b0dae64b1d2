"""Offline evaluation CLI (port of tools/detzero_eval.py; reference
evaluator/detzero_eval.py surface): pair prediction and GT pickles by
(sequence, frame), pad missing frames with empty predictions, run the
Waymo-protocol metrics (`pipeline/evaluator.py`), print the table.

    python -m detzero_tpu_torch.tools.detzero_eval \
        --pred_path output/offboard/final_frames.pkl --gt_path gt.pkl \
        [--ap_mode waymo101] [--range_breakdown] [--metric tracking]

With a final_frames.pkl (global boxes, `tools/run_offboard.py`) the GT
pickle is paired as given: GT in the vehicle frame (the infos'
`gt_boxes_lidar`) must be posed into the global frame first, or any
sequence with ego motion scores near 0.  Host code (NumPy).  `main(argv)`
runs in-process and returns the results dict (per class, as
`evaluate_detection` or `evaluate_tracking_by_class` gives it).
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def frames_from_final(final, class_names):
    """{seq: [{'boxes','scores','obj_ids'}]} -> flat pred dicts. Class names
    are unknown at this level; a 'labels' entry per frame is used if present,
    else boxes are labeled by size heuristic (vehicle vs pedestrian/cyclist)."""
    preds = []
    keys = []
    for seq in sorted(final):
        for fi, fr in enumerate(final[seq]):
            boxes = np.asarray(fr["boxes"]).reshape(-1, 7)
            if "labels" in fr:
                names = np.asarray([class_names[int(l)] for l in fr["labels"]])
            else:
                names = np.where(boxes[:, 3] > 2.5, class_names[0],
                                 class_names[1]).astype(object)
            preds.append({"boxes_lidar": boxes,
                          "score": np.asarray(fr["scores"]),
                          "name": names})
            keys.append((seq, fi))
    return preds, keys


def final_frame_gts(gts_raw, keys):
    """The GT dicts of `keys` ((seq, frame) pairs of frames_from_final)
    from a {seq: [per-frame GT]} or flat-list pickle."""
    gts = []
    for seq, fi in keys:
        g = gts_raw[seq][fi] if isinstance(gts_raw, dict) else gts_raw[fi]
        names = np.asarray(g.get("name", g.get("names", [])))
        gts.append({
            "gt_boxes": np.asarray(g.get("gt_boxes", g.get("boxes",
                                                           np.zeros((0, 7))))),
            "name": names,
            "num_points": np.asarray(g.get("num_points",
                                           np.full(len(names), 100))),
        })
    return gts


def main(argv=None):
    from detzero_tpu_torch.core.logger import create_logger
    from detzero_tpu_torch.pipeline.evaluator import (
        evaluate_detection, format_results_table,
    )

    p = argparse.ArgumentParser("offline detection eval")
    p.add_argument("--pred_path", required=True,
                   help="result.pkl (frame dicts) or final_frames.pkl")
    p.add_argument("--gt_path", required=True,
                   help="pickle: list of {'gt_boxes','name','num_points'} or "
                        "{seq: [per-frame gt dicts]}")
    p.add_argument("--class_names", nargs="+",
                   default=["Vehicle", "Pedestrian", "Cyclist"])
    p.add_argument("--range_breakdown", action="store_true")
    p.add_argument("--ap_mode", default="envelope",
                   choices=["envelope", "waymo101"],
                   help="waymo101 = reference TF op protocol: PR sampled at "
                        "101 fixed score cutoffs, re-matched per cutoff")
    p.add_argument("--metric", default="detection",
                   choices=["detection", "tracking"],
                   help="tracking = per-class CLEAR-MOT "
                        "(waymo_eval_tracking.py quantities); pred/gt "
                        "pickles must carry per-frame obj_ids")
    args = p.parse_args(argv)
    logger = create_logger()

    with open(args.pred_path, "rb") as f:
        preds_raw = pickle.load(f)
    with open(args.gt_path, "rb") as f:
        gts_raw = pickle.load(f)

    if args.metric == "tracking":
        # {seq: [ {'boxes','obj_ids','name'} per frame ]} on both sides
        from detzero_tpu_torch.pipeline.evaluator import (
            evaluate_tracking_by_class,
        )
        seqs = [(preds_raw[seq], gts_raw[seq]) for seq in sorted(preds_raw)
                if seq in gts_raw]
        res = evaluate_tracking_by_class(seqs,
                                         class_names=tuple(args.class_names))
        logger.info("\n" + format_results_table(
            {c: {k: v for k, v in m.items() if k != "num_gt"}
             for c, m in res.items()}))
        return res

    if isinstance(preds_raw, dict):  # final_frames format
        preds, keys = frames_from_final(preds_raw, args.class_names)
        gts = final_frame_gts(gts_raw, keys)
    else:  # flat list of frame dicts, pair by (sequence_name, frame_id)
        gt_by_key = {}
        if isinstance(gts_raw, list):
            for g in gts_raw:
                gt_by_key[(g.get("sequence_name"), g.get("frame_id"))] = g
        preds, gts = [], []
        for d in preds_raw:
            key = (d.get("sequence_name"), d.get("frame_id"))
            g = gt_by_key.get(key, {})
            preds.append(d)
            gts.append({
                "gt_boxes": np.asarray(g.get("gt_boxes", np.zeros((0, 7)))),
                "name": np.asarray(g.get("name", [])),
                "num_points": np.asarray(g.get("num_points",
                                               np.full(len(g.get("name", [])),
                                                       100))),
            })

    res = evaluate_detection(preds, gts, class_names=tuple(args.class_names),
                             with_range_breakdown=args.range_breakdown,
                             ap_mode=args.ap_mode)
    logger.info("\n" + format_results_table(res))
    return res


if __name__ == "__main__":
    main()

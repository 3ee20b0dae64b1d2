"""Offline detection ensembling (port of tools/ensemble_dets.py): fuse
several result.pkl files with WBF.

The reference's published 76.24 DET APH is an ensemble over several
det_model_cfgs (5sweeps / 3sweeps / pdv / pdv_small) fused by
weighted_boxes_fusion_3d (utils/ensemble_utils/wbf_3d.py, "wbf_offline"
workflow). This CLI expresses that recipe: N result pickles (one per
trained config, aligned frame order) -> per-frame per-class WBF with
n_models = N -> fused result.pkl [-> optional evaluation vs a GT pickle].

    python -m detzero_tpu_torch.tools.ensemble_dets \
        --results a/result.pkl b/result.pkl --output fused.pkl \
        [--gt_path gt.pkl]

`main(argv)` runs in-process and returns (the fused det_annos, the
evaluation's results or None).
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np


def fuse_result_lists(results, class_names=("Vehicle", "Pedestrian",
                                            "Cyclist"), iou_thresh=None,
                      skip_thresh=None):
    """results: list of det_annos lists (same frames, same order).
    Returns one fused det_annos list."""
    from detzero_tpu_torch.ops import wbf

    n_models = len(results)
    n_frames = len(results[0])
    for r in results[1:]:
        assert len(r) == n_frames, "result files cover different frame sets"
    fused = []
    for fi in range(n_frames):
        frames = [r[fi] for r in results]
        ids = [f.get("frame_id") for f in frames]
        assert all(i == ids[0] for i in ids), \
            f"frame_id mismatch at index {fi}: {ids}"
        names = np.concatenate([np.asarray(f["name"]) for f in frames])
        boxes = np.concatenate([np.asarray(f["boxes_lidar"], float)[:, :7]
                                for f in frames])
        scores = np.concatenate([np.asarray(f["score"], float)
                                 for f in frames])
        n, b, s = wbf.wbf_online(names, boxes, scores,
                                 class_names=class_names,
                                 iou_thresh=iou_thresh,
                                 skip_thresh=skip_thresh, n_models=n_models)
        out = dict(frames[0])
        out["name"], out["boxes_lidar"], out["score"] = n, b, s
        fused.append(out)
    return fused


def main(argv=None):
    from detzero_tpu_torch.core.logger import create_logger

    p = argparse.ArgumentParser("WBF detection ensemble")
    p.add_argument("--results", nargs="+", required=True,
                   help="two or more result.pkl files (aligned frames)")
    p.add_argument("--output", required=True)
    p.add_argument("--gt_path", default=None)
    p.add_argument("--class_names", nargs="+",
                   default=["Vehicle", "Pedestrian", "Cyclist"])
    args = p.parse_args(argv)
    logger = create_logger()

    results = []
    for rp in args.results:
        with open(rp, "rb") as f:
            results.append(pickle.load(f))
        logger.info(f"{rp}: {len(results[-1])} frames")
    fused = fuse_result_lists(results, class_names=tuple(args.class_names))
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(fused, f)
    logger.info(f"wrote {args.output} ({len(fused)} frames)")

    res = None
    if args.gt_path:
        from detzero_tpu_torch.pipeline.evaluator import (
            evaluate_detection, format_results_table,
        )
        with open(args.gt_path, "rb") as f:
            gts = pickle.load(f)
        res = evaluate_detection(fused, gts,
                                 class_names=tuple(args.class_names))
        logger.info("\n" + format_results_table(res))
    return fused, res


if __name__ == "__main__":
    main()

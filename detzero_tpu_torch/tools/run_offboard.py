"""One-command offboard pipeline (port of tools/run_offboard.py):
detections -> track -> object prep -> refine -> combine (-> eval), per
sequence.

    python -m detzero_tpu_torch.tools.run_offboard --det_path result.pkl \
        --points_root data/waymo/waymo_processed_data \
        [--gt_path gt.pkl] [--grm_cfg cfg.yaml --grm_ckpt dir] [...] \
        [--viewer_html] [--device cuda] \
        [--track_cfg configs/tk_model_cfgs/waymo_detzero_track.yaml] \
        [--set MODEL.TRACKING.SCORE_THRESH 0.0 ...]

The reference has NO orchestrator — its stages talk through pickles and
six separate CLIs (SURVEY §3.5).  This CLI runs the same stages
in-process through `pipeline.offboard.OffboardPipeline`, writes the
reference's artifacts (`tracking_<seq>.pkl`, `objects_<seq>.pkl`,
`final_frames.pkl`) and logs the per-stage StageTimer report.

Each refiner is the port's `train_refine` model of its yaml with the
newest checkpoint of its directory restored, on --device (the card unless
--device cpu).  `--points_root` is a directory of `<seq>.pkl`
{points, poses} blobs or the preprocessed tree of `create_waymo_infos`
(`tools.common.load_sequence_points`).  Without --track_cfg the tracker
takes its built-in defaults, as the reference's run_offboard does; --track_cfg
and --set (which must come last) give it a tracking yaml's MODEL.

With --gt_path the final frames, which are global, are scored against the
GT pickle as given (as the reference does): pose vehicle-frame GT first.
`main(argv)` runs in-process and returns {final_frames, final_path,
tracking_paths, objects_paths, timings, report, results}.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

STAGES = ("grm", "prm", "crm")


def load_refiner(cfg_path, ckpt_dir, device):
    """(model, sampler kwargs) of OffboardPipeline for one refining yaml
    and the newest checkpoint under `ckpt_dir`."""
    from detzero_tpu_torch.core.checkpoint import CheckpointManager
    from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
    from detzero_tpu_torch.tools.train_refine import build_refine_model

    cfg = cfg_from_yaml_file(cfg_path, Config())
    model = build_refine_model(cfg, device)
    if not Path(ckpt_dir).is_dir() or \
            CheckpointManager(ckpt_dir).restore(model) is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    sampler_kwargs = {
        k.lower(): int(cfg[k])
        for k in ("QUERY_NUM", "QUERY_POINTS", "MEMORY_POINTS") if k in cfg
    }
    return model, sampler_kwargs


def main(argv=None):
    from detzero_tpu_torch.core.config import (
        Config, cfg_from_list, cfg_from_yaml_file,
    )
    from detzero_tpu_torch.core.logger import create_logger
    from detzero_tpu_torch.pipeline.offboard import OffboardPipeline
    from detzero_tpu_torch.tools.common import (
        load_sequence_points, resolve_device,
    )
    from detzero_tpu_torch.tools.run_track import group_by_sequence

    p = argparse.ArgumentParser("offboard pipeline")
    p.add_argument("--det_path", required=True, help="detection result.pkl")
    p.add_argument("--points_root", required=True)
    p.add_argument("--output_dir", default="output/offboard")
    p.add_argument("--class_names", nargs="+",
                   default=["Vehicle", "Pedestrian", "Cyclist"])
    p.add_argument("--gt_path", default=None,
                   help="optional GT pickle for final-frame evaluation")
    for stage in STAGES:
        p.add_argument(f"--{stage}_cfg", default=None)
        p.add_argument(f"--{stage}_ckpt", default=None)
    p.add_argument("--viewer_html", action="store_true",
                   help="also write an interactive <seq>.html viewer per "
                        "sequence (utils/webviewer, no dependencies)")
    p.add_argument("--device", default="cuda",
                   help="device of the refiners ('cuda' by default)")
    p.add_argument("--track_cfg", default=None,
                   help="tracking yaml whose MODEL configures the tracker "
                        "(default: the tracker's built-in defaults)")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER,
                   default=None, help="dotted overrides of --track_cfg")
    args = p.parse_args(argv)
    logger = create_logger()

    track_cfg = None
    if args.track_cfg:
        cfg = cfg_from_yaml_file(args.track_cfg, Config())
        if args.set_cfgs:
            cfg_from_list(args.set_cfgs, cfg)
        track_cfg = cfg.get("MODEL", {})
    elif args.set_cfgs:
        raise ValueError("--set overrides --track_cfg, which is not given")

    with open(args.det_path, "rb") as f:
        det_annos = pickle.load(f)
    seqs = group_by_sequence(det_annos, args.class_names)
    logger.info(f"{len(seqs)} sequences, {len(det_annos)} frames")

    stages = {}
    for stage in STAGES:
        cfg_p = getattr(args, f"{stage}_cfg")
        ck = getattr(args, f"{stage}_ckpt")
        if cfg_p and ck:
            device = resolve_device(args.device)
            stages[stage] = load_refiner(cfg_p, ck, device)
            logger.info(f"{stage}: loaded {cfg_p} @ {ck} on {device}")

    pipe = OffboardPipeline(track_cfg, class_names=args.class_names,
                            **stages)
    out_root = Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    final_frames, tracking_paths, objects_paths = {}, {}, {}
    for seq, frames in seqs.items():
        loaded = load_sequence_points(args.points_root, seq)
        if loaded is None:
            logger.warning(f"no points for {seq}; object prep will see "
                           f"empty clouds")
            loaded = ([np.zeros((0, 4), np.float32)] * len(frames),
                      [np.eye(4)] * len(frames))
        pts, poses = loaded
        res = pipe.run_sequence(frames, pts, poses)
        final_frames[seq] = res["frames"]
        tracking_paths[seq] = out_root / f"tracking_{seq}.pkl"
        objects_paths[seq] = out_root / f"objects_{seq}.pkl"
        pipe.save_artifact(res["tracks"], tracking_paths[seq])
        pipe.save_artifact(res["objects"], objects_paths[seq])
        if args.viewer_html:
            from detzero_tpu_torch.utils.webviewer import export_from_offboard
            export_from_offboard(res["frames"], pts, poses=poses,
                                 class_names=tuple(args.class_names),
                                 out_path=out_root / f"{seq}.html",
                                 title=seq)
    final_path = out_root / "final_frames.pkl"
    pipe.save_artifact(final_frames, final_path)
    report = pipe.timer.report()
    logger.info("stage timings:\n" + report)
    logger.info(f"wrote {final_path}")

    results = None
    if args.gt_path:
        from detzero_tpu_torch.pipeline.evaluator import (
            evaluate_detection, format_results_table,
        )
        from detzero_tpu_torch.tools.detzero_eval import (
            final_frame_gts, frames_from_final,
        )

        with open(args.gt_path, "rb") as f:
            gts_raw = pickle.load(f)
        preds, keys = frames_from_final(final_frames, args.class_names)
        results = evaluate_detection(preds, final_frame_gts(gts_raw, keys),
                                     class_names=tuple(args.class_names))
        logger.info("\n" + format_results_table(results))
    return {"final_frames": final_frames, "final_path": final_path,
            "tracking_paths": tracking_paths, "objects_paths": objects_paths,
            "timings": pipe.timer.as_dict(), "report": report,
            "results": results}


if __name__ == "__main__":
    main()

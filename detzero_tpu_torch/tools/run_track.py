"""Offline tracking CLI (port of tools/run_track.py; reference
tracking/tools/run_track.py surface): load a detection result pickle, run
per-sequence tracking in a process pool, save the tracking and drop
pickles.

    python -m detzero_tpu_torch.tools.run_track --data_path result.pkl

The tracker is numpy and scipy on the host.  The pool's processes are
started with "spawn", never "fork": the caller may have initialised CUDA
(test_det before it, in one process), and a forked child of such a process
must not touch CUDA.  The children import the tracker only, not torch's
CUDA state.  `main(argv)` runs in-process and returns {"tracks": the
per-sequence tracker outputs, "track_path", "drop_path"}.
"""

from __future__ import annotations

import argparse
import multiprocessing
import pickle
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np


def group_by_sequence(det_annos, class_names):
    """Flat frame dicts -> {seq: [frame dicts for the tracker]}."""
    seqs = {}
    for d in det_annos:
        seq = d.get("sequence_name", "seq0")
        labels = np.array([class_names.index(n) if n in class_names else 0
                           for n in d.get("name", [])])
        seqs.setdefault(seq, []).append({
            "boxes": np.asarray(d["boxes_lidar"])[:, :7],
            "scores": np.asarray(d["score"]),
            "labels": labels,
            "pose": d.get("pose", np.eye(4)),
            "frame_id": d.get("frame_id"),
        })
    return seqs


def _track_one(args):
    cfg, frames = args
    from detzero_tpu_torch.models.tracking import DetZeroTracker
    return DetZeroTracker(cfg)(frames)


def track_sequences(model_cfg, seqs, workers: int):
    """{seq: frames} -> {seq: tracker output}, over a pool of `workers`
    spawned processes when there is more than one sequence and worker."""
    jobs = [(model_cfg, frames) for frames in seqs.values()]
    if workers > 1 and len(jobs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(jobs)),
                                 mp_context=ctx) as pool:
            results = list(pool.map(_track_one, jobs))
    else:
        results = [_track_one(j) for j in jobs]
    return dict(zip(seqs.keys(), results))


def main(argv=None):
    from detzero_tpu_torch.core.config import (
        Config, cfg_from_list, cfg_from_yaml_file,
    )
    from detzero_tpu_torch.core.logger import create_logger

    p = argparse.ArgumentParser("detzero_tpu_torch offline tracking")
    p.add_argument("--cfg_file",
                   default="configs/tk_model_cfgs/waymo_detzero_track.yaml")
    p.add_argument("--data_path", required=True, help="detection result.pkl")
    p.add_argument("--output_dir", default="output/tracking")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--split", default="val")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER,
                   default=None)
    args = p.parse_args(argv)

    cfg = cfg_from_yaml_file(args.cfg_file, Config())
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(out_dir / "log_track.txt")

    with open(args.data_path, "rb") as f:
        det_annos = pickle.load(f)
    class_names = list(cfg.get("CLASS_NAMES", ["Vehicle", "Pedestrian",
                                               "Cyclist"]))
    seqs = group_by_sequence(det_annos, class_names)
    logger.info(f"{len(seqs)} sequences, {len(det_annos)} frames")

    t0 = time.time()
    track_data = track_sequences(cfg.get("MODEL", {}), seqs, args.workers)
    logger.info(f"tracked in {time.time()-t0:.1f}s")

    stamp = time.strftime("%Y%m%d-%H%M%S")
    track_path = out_dir / f"tracking-{args.split}-{stamp}.pkl"
    drop_path = out_dir / f"drop-{args.split}-{stamp}.pkl"
    with open(track_path, "wb") as f:
        pickle.dump({k: {"tracks": v["tracks"]}
                     for k, v in track_data.items()}, f)
    with open(drop_path, "wb") as f:
        pickle.dump({k: v["drop"] for k, v in track_data.items()}, f)
    n_tracks = sum(len(v["tracks"]) for v in track_data.values())
    logger.info(f"{n_tracks} tracks -> {track_path}")
    return {"tracks": track_data, "track_path": track_path,
            "drop_path": drop_path}


if __name__ == "__main__":
    main()

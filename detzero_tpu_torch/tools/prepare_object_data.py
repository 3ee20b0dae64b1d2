"""Daemon CLI (port of tools/prepare_object_data.py; reference
daemon/prepare_object_data.py surface): a tracking pickle and per-frame
points -> per-class, per-sequence refining records.

    python -m detzero_tpu_torch.tools.prepare_object_data \
        --track_path output/tracking/tracking-val-<stamp>.pkl \
        --points_root <dir with <seq>.pkl {points, poses}, or the
                       preprocessed tree: <seq>.pkl infos, <seq>/NNNN.npy>

Host code: the crop is the native C++ cropper, or the reference's NumPy
route where g++ builds nothing; the log says which route cropped how many
frames (`daemon.NATIVE_FRAMES`, `daemon.NUMPY_FRAMES`).  `main(argv)` runs
in-process and returns {class name: {sequence: path of its pickle}}.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def main(argv=None):
    from detzero_tpu_torch.core.logger import create_logger
    from detzero_tpu_torch.pipeline import daemon
    from detzero_tpu_torch.tools.common import load_sequence_points

    p = argparse.ArgumentParser("prepare per-object refining data")
    p.add_argument("--track_path", required=True, help="tracking-<split>.pkl")
    p.add_argument("--points_root", required=True,
                   help="dir with <seq>.pkl holding {'points': [...], "
                        "'poses': [...]}, or a preprocessed tree "
                        "(<seq>.pkl infos + <seq>/NNNN.npy)")
    p.add_argument("--output_dir", default="data/waymo/refining")
    p.add_argument("--class_names", nargs="+",
                   default=["Vehicle", "Pedestrian", "Cyclist"])
    p.add_argument("--enlarge", type=float, default=1.1)
    args = p.parse_args(argv)
    logger = create_logger()

    with open(args.track_path, "rb") as f:
        tracking = pickle.load(f)
    out_root = Path(args.output_dir)
    written = {}
    before = (daemon.NATIVE_FRAMES, daemon.NUMPY_FRAMES)
    for seq, tr in tracking.items():
        loaded = load_sequence_points(args.points_root, seq)
        if loaded is None:
            logger.warning(f"no points for {seq}, skipping")
            continue
        frame_points, poses = loaded
        recs = daemon.prepare_object_data(tr, frame_points, poses,
                                          enlarge=args.enlarge)
        by_cls = {}
        for oid, rec in recs.items():
            label = rec.get("label", 0)
            cls = (args.class_names[int(label)]
                   if not isinstance(label, str) else label)
            by_cls.setdefault(cls, {})[oid] = rec
        for cls, d in by_cls.items():
            out = out_root / cls / f"{seq}.pkl"
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out, "wb") as f:
                pickle.dump(d, f)
            written.setdefault(cls, {})[seq] = out
            logger.info(f"{seq} {cls}: {len(d)} objects -> {out}")
    logger.info(f"frames cropped: native "
                f"{daemon.NATIVE_FRAMES - before[0]}, numpy "
                f"{daemon.NUMPY_FRAMES - before[1]}")
    return written


if __name__ == "__main__":
    main()

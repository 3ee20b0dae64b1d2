"""Daemon CLI (port of tools/combine_output.py; reference
daemon/combine_output.py surface): merge GRM/PRM/CRM outputs (+tracker
drop data) into final frame-level detections.

    python -m detzero_tpu_torch.tools.combine_output \
        --object_root data/waymo/refining \
        --geometry_path Vehicle_geometry_val.pkl \
        --position_path Vehicle_position_val.pkl \
        --confidence_path Vehicle_confidence_val.pkl \
        --output_path output/final_frames.pkl

Host code (NumPy).  The pickle is {seq: [frame dicts {'boxes', 'scores',
'obj_ids', 'labels'}]}, global frame, classes merged.  `main(argv)` runs
in-process and returns that dict.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np


def main(argv=None):
    from detzero_tpu_torch.core.logger import create_logger
    from detzero_tpu_torch.pipeline import daemon

    p = argparse.ArgumentParser("combine refinement outputs")
    p.add_argument("--object_root", required=True,
                   help="refining records root (per-class dirs)")
    p.add_argument("--geometry_path", default=None)
    p.add_argument("--position_path", default=None)
    p.add_argument("--confidence_path", default=None)
    p.add_argument("--combine_drop_path", default=None)
    p.add_argument("--output_path", default="output/final_frames.pkl")
    p.add_argument("--class_names", nargs="+",
                   default=["Vehicle", "Pedestrian", "Cyclist"])
    args = p.parse_args(argv)
    logger = create_logger()

    def load(path):
        if path is None:
            return {}
        with open(path, "rb") as f:
            return pickle.load(f)

    geo, pos, conf = load(args.geometry_path), load(args.position_path), \
        load(args.confidence_path)
    drops = load(args.combine_drop_path)

    final = {}
    for cls in args.class_names:
        cls_dir = Path(args.object_root) / cls
        if not cls_dir.exists():
            continue
        for pkl in sorted(cls_dir.glob("*.pkl")):
            seq = pkl.stem
            with open(pkl, "rb") as f:
                recs = pickle.load(f)
            g = {oid: v["size"] for oid, v in geo.get(seq, {}).items()
                 if oid in recs} or None
            pc = {oid: v["centers"] for oid, v in pos.get(seq, {}).items()
                  if oid in recs} or None
            ph = {oid: v["headings"] for oid, v in pos.get(seq, {}).items()
                  if oid in recs} or None
            cs = {oid: v["new_score"] for oid, v in conf.get(seq, {}).items()
                  if oid in recs} or None
            frames = daemon.combine_output(
                recs, grm_sizes=g, prm_centers=pc, prm_headings=ph,
                crm_scores=cs, drop_data=drops.get(seq))
            if seq in final:  # merge classes — every per-box array
                for a, b in zip(final[seq], frames):
                    for k in ("boxes", "scores", "obj_ids", "labels"):
                        a[k] = np.concatenate([a[k], b[k]])
            else:
                final[seq] = frames
    with open(args.output_path, "wb") as f:
        pickle.dump(final, f)
    n = sum(len(v) for v in final.values())
    logger.info(f"combined {len(final)} sequences / {n} frames -> "
                f"{args.output_path}")
    return final


if __name__ == "__main__":
    main()

"""Waymo preprocessing CLI (port of tools/create_waymo_infos.py; reference
waymo_preprocess.py surface): tfrecords -> per-frame npy + info pkls +
GT sampling database.

    python -m detzero_tpu_torch.tools.create_waymo_infos --stage infos \
        --raw_dir data/waymo/raw_data \
        --out_dir data/waymo/waymo_processed_data \
        --split_file data/waymo/ImageSets/train.txt
    python -m detzero_tpu_torch.tools.create_waymo_infos \
        --stage gt_database --infos_path data/waymo/waymo_infos_train.pkl

Host code (NumPy, the package's protobuf codec, the native CRC); it needs
no card.  `main(argv)` runs in-process and returns the infos (stage
infos) or the GT database (stage gt_database).
"""

from __future__ import annotations

import argparse
import pickle


def main(argv=None):
    from detzero_tpu_torch.core.logger import create_logger
    from detzero_tpu_torch.data import waymo_preprocess as wp

    p = argparse.ArgumentParser("waymo preprocessing")
    p.add_argument("--stage", choices=["infos", "gt_database"], required=True)
    p.add_argument("--raw_dir", default="data/waymo/raw_data")
    p.add_argument("--out_dir", default="data/waymo/waymo_processed_data")
    p.add_argument("--split_file", default="data/waymo/ImageSets/train.txt")
    p.add_argument("--infos_path", default="data/waymo/waymo_infos_train.pkl")
    p.add_argument("--db_out", default="data/waymo/waymo_dbinfos_train.pkl")
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    logger = create_logger()

    if args.stage == "infos":
        infos = wp.create_waymo_infos(args.raw_dir, args.out_dir,
                                      args.split_file, args.workers)
        logger.info(f"wrote {len(infos)} frame infos")
        return infos
    with open(args.infos_path, "rb") as f:
        infos = pickle.load(f)
    db = wp.create_gt_database(infos, args.out_dir, args.db_out)
    logger.info("gt database: " + ", ".join(
        f"{k}:{len(v)}" for k, v in db.items()))
    return db


if __name__ == "__main__":
    main()

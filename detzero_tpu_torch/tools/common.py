"""Shared CLI plumbing (port of tools/common.py; reference train.py:23
parse_config pattern): --cfg_file + --set dotted overrides + experiment dir
derivation, the device and process group of a rank, the functions that
make the detection dataset and model, and the per-sequence points loader
of the offboard CLIs."""

from __future__ import annotations

import argparse
import datetime
import pickle
import shutil
from pathlib import Path

import numpy as np
import torch

from detzero_tpu_torch.core.config import (
    Config, cfg_from_list, cfg_from_yaml_file,
)
from detzero_tpu_torch.core.logger import create_logger


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg_file", required=True, help="model config yaml")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--output_dir", default="output")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of a few train steps "
                        "into this dir (Chrome trace format)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda' by default; "
                        "'cpu' runs every kernel's plain version)")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER,
                   default=None, help="dotted-path config overrides")
    return p


def resolve_device(name: str) -> torch.device:
    """The device named on the command line, where a bare "cuda" is this
    rank's card (cuda:LOCAL_RANK under torchrun or SLURM); a card must be
    there."""
    from detzero_tpu_torch.core.mesh import rank_device

    return rank_device(name)


def init_data_parallel(name: str):
    """The device of `--device name` and the process group of a torchrun
    or SLURM launch (NCCL on a card, gloo on the CPU; none for one
    process, nor where the caller made its own): (device, rank, world)."""
    from detzero_tpu_torch.core.mesh import init_distributed

    device = resolve_device(name)
    rank, world = init_distributed(device=device)
    return device, rank, world


def load_config(args) -> Config:
    cfg = cfg_from_yaml_file(args.cfg_file, Config())
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    if args.batch_size is not None:
        cfg.setdefault("OPTIMIZATION", Config())
        cfg["OPTIMIZATION"]["BATCH_SIZE_PER_DEVICE"] = args.batch_size
    if args.epochs is not None:
        cfg["OPTIMIZATION"]["NUM_EPOCHS"] = args.epochs
    return cfg


def setup_experiment(args, cfg, phase: str):
    """Experiment dir <output>/<cfg-stem>/<extra_tag>/ with cfg copy + logger
    (reference train.py:87,105-106)."""
    from detzero_tpu_torch.core.mesh import get_dist_info

    exp_dir = Path(args.output_dir) / Path(args.cfg_file).stem / args.extra_tag
    exp_dir.mkdir(parents=True, exist_ok=True)
    if get_dist_info()[0] != 0:
        # rank 0 alone writes the experiment's files
        return exp_dir, create_logger()
    try:
        shutil.copy(args.cfg_file, exp_dir / Path(args.cfg_file).name)
    except shutil.SameFileError:
        pass
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    logger = create_logger(exp_dir / f"log_{phase}_{stamp}.txt")
    return exp_dir, logger


def build_detection_dataset(cfg, training: bool, logger=None, rng=None):
    from detzero_tpu_torch.core.registry import DATASETS
    import detzero_tpu_torch.data.waymo_dataset  # noqa: F401 (registers)

    name = cfg.get("DATASET", "WaymoDetectionDataset")
    classes = cfg.get("CLASS_NAMES", ["Vehicle", "Pedestrian", "Cyclist"])
    return DATASETS.get(name)(cfg, classes, training=training, logger=logger,
                              rng=rng)


def build_detector(cfg, device, dtype=torch.bfloat16, seed: int = 0):
    """The config's CenterPoint on `device`, its weights drawn on the CPU
    from `seed` (the same on every device), with as many point features
    as POINT_FEATURE_ENCODING.used_feature_list names."""
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    m = cfg["MODEL"]
    voxel_size = None
    for proc in cfg.get("DATA_PROCESSOR", []):
        if "VOXEL_SIZE" in proc:
            voxel_size = proc["VOXEL_SIZE"]
    if voxel_size is None:
        raise ValueError("DATA_PROCESSOR must define VOXEL_SIZE")
    used = cfg.get("POINT_FEATURE_ENCODING", {}).get(
        "used_feature_list",
        ["x", "y", "z", "intensity", "elongation", "time_offset"])
    model = CenterPoint(
        m, len(cfg.get("CLASS_NAMES", [1, 2, 3])),
        pc_range=cfg["POINT_CLOUD_RANGE"], voxel_size=voxel_size,
        max_voxels=int(m.get("MAX_VOXELS", 150_000)),
        max_points=int(cfg.get("NUM_POINT_BUDGET", 200_000)),
        max_objs=int(cfg.get("MAX_OBJS", 500)),
        num_point_features=len(used), dtype=dtype, device="cpu")
    model.init_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def load_sequence_points(points_root, seq):
    """(frame points, poses) of sequence `seq` under `points_root`, or None
    where it has neither `<seq>.pkl` nor `<seq>/`.  Two layouts:

      * `<seq>.pkl` holding {'points': [...], 'poses': [...]};
      * the preprocessed tree (`data/waymo_preprocess.py`): `<seq>.pkl` is
        the sequence's info list, each info's 'pose' the frame's pose, its
        points `<seq>/NNNN.npy` by `point_cloud.sample_idx`, in the list's
        order.

    A `<seq>/` directory without `<seq>.pkl` has points but no poses, and
    raises: taking its vehicle-frame points for global ones would crop
    every moving frame's boxes from the wrong place.  (The reference's
    run_offboard and prepare_object_data read the info list as a blob,
    which raises TypeError, and read a bare directory with identity
    poses.)"""
    root = Path(points_root)
    pkl, seq_dir = root / f"{seq}.pkl", root / seq
    if pkl.exists():
        with open(pkl, "rb") as f:
            blob = pickle.load(f)
        if isinstance(blob, dict):
            return blob["points"], blob["poses"]
        points = [np.load(seq_dir / f"{info['point_cloud']['sample_idx']:04d}"
                                    ".npy") for info in blob]
        return points, [info["pose"] for info in blob]
    if seq_dir.exists():
        raise FileNotFoundError(
            f"{seq_dir} holds points but {pkl} is missing: neither a "
            f"{{points, poses}} blob nor the preprocessed info list gives "
            f"the frames' poses")
    return None

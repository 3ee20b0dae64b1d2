"""Process-aware logging and seeding (port of detzero_tpu/core/logger.py;
reference: common_utils.py:20-58).

Rank 0 logs at the requested level to the console and an optional file;
other processes log at ERROR only.  The rank is torch.distributed's when a
process group is initialised, else 0.
"""

from __future__ import annotations

import logging
import random

import numpy as np
import torch


def get_rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def create_logger(log_file=None, rank: int | None = None,
                  log_level=logging.INFO):
    if rank is None:
        rank = get_rank()
    logger = logging.getLogger(f"detzero_tpu_torch.r{rank}.{log_file}")
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    if logger.handlers:
        return logger
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    console = logging.StreamHandler()
    console.setLevel(log_level if rank == 0 else logging.ERROR)
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setLevel(log_level if rank == 0 else logging.ERROR)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

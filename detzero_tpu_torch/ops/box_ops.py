"""Box geometry used by decode and NMS (port of the matching functions of
`detzero_tpu/ops/box_ops.py`)."""

from __future__ import annotations

import math

import torch


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap to [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def boxes3d_to_bev(boxes3d):
    """(N, 7) -> (N, 5) [x, y, dx, dy, heading]."""
    return boxes3d[:, [0, 1, 3, 4, 6]]

"""Refining target encode/decode (port of
detzero_tpu/models/refining/target_assign.py), in torch and float32 as the
reference computes them:

  * GRM (geometry): size targets are residuals to the NEAREST of K
    per-class size anchors, plus anchor classification;
  * PRM (position): center residual + 12-bin heading classification with
    an in-bin residual;
  * CRM (confidence): pos/neg labels from per-box IoU with an ignore band.

`argmin` and `argmax` take the first index on ties, as jnp's do, and the
heading's modulo is jnp.mod's (the remainder of fmod, moved into the
divisor's sign), so bin edges fall where the reference puts them.
"""

from __future__ import annotations

import math

import torch

# default per-class size anchors (l, w, h) — Waymo-scale clusters
DEFAULT_SIZE_ANCHORS = {
    "Vehicle": [[4.7, 2.1, 1.7], [8.5, 2.8, 3.2], [12.0, 2.9, 3.6]],
    "Pedestrian": [[0.9, 0.85, 1.7], [1.1, 1.0, 1.9], [0.7, 0.7, 1.5]],
    "Cyclist": [[1.8, 0.85, 1.7], [2.2, 1.0, 1.9], [1.5, 0.7, 1.6]],
}

NUM_HEADING_BINS = 12


def _anchors(anchors, like):
    return torch.as_tensor(anchors, dtype=torch.float32, device=like.device)


def encode_size(gt_size, anchors):
    """gt_size (..., 3), anchors (K, 3) -> (anchor_cls (...,) int64,
    residual (..., K, 3)).  The residual is log(gt / anchor) for every
    anchor; the loss gathers the target one."""
    a = _anchors(anchors, gt_size)
    g = gt_size[..., None, :]
    res = torch.log(torch.clamp(g, min=1e-4) / a)
    cls = torch.argmin((g - a).abs().sum(-1), dim=-1)
    return cls, res


def decode_size(anchor_logits, residuals, anchors):
    """anchor_logits (..., K), residuals (..., K, 3) -> size (..., 3) by
    the argmax anchor and its residual.  anchors (K, 3), or one set a
    sample broadcastable to (..., K, 3)."""
    k = torch.argmax(anchor_logits, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 1, 3)
    res = torch.gather(residuals, -2, idx)[..., 0, :]
    a = _anchors(anchors, anchor_logits).expand(*residuals.shape)
    base = torch.gather(a, -2, idx)[..., 0, :]
    return base * torch.exp(torch.clamp(res, -2.0, 2.0))


def _mod(x, y: float):
    """jnp.mod: fmod's remainder, plus y where it is non-zero and of the
    other sign (exact in floating point)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def encode_heading(heading):
    """heading (...,) float32 -> (bin (...,) int32, in-bin residual (...,))
    over 12 bins."""
    period = 2 * math.pi / NUM_HEADING_BINS
    shifted = _mod(heading + math.pi, 2 * math.pi)    # [0, 2pi)
    b = torch.clamp((shifted / period).to(torch.int32), 0,
                    NUM_HEADING_BINS - 1)
    residual = shifted - (b.to(torch.float32) + 0.5) * period
    return b, residual


def decode_heading(bin_logits, residuals):
    """bin_logits (..., 12), residuals (..., 12) -> heading (...,)."""
    period = 2 * math.pi / NUM_HEADING_BINS
    b = torch.argmax(bin_logits, dim=-1)
    res = torch.gather(residuals, -1, b[..., None])[..., 0]
    return (b.to(torch.float32) + 0.5) * period + res - math.pi


def confidence_labels(ious, lo: float, hi: float):
    """per-box IoU -> (labels in {0, 1}, weights).  IoUs inside (lo, hi)
    are the ignore band (weight 0); padding uses iou < 0."""
    pos = ious >= hi
    neg = (ious <= lo) & (ious >= 0.0)
    return pos.to(torch.float32), (pos | neg).to(torch.float32)

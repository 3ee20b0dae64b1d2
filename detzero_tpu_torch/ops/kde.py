"""Gaussian kernel density estimation over grouped neighborhoods (port of
detzero_tpu/ops/kde.py; reference utils/detzero_utils/kde_utils.py:15-50):
per query ball, the density is logsumexp of isotropic Gaussian kernels over
the sampled neighbors — the PDV attention variant's positional density
feature (StackSAModuleMSGAttention, pointnet2_stack/pointnet2_modules.py:117).
Plain torch on tensors, on their device."""

from __future__ import annotations

import math

import torch


def gaussian_kde_density(grouped_xyz: torch.Tensor, found: torch.Tensor,
                         bandwidth: float = 0.5) -> torch.Tensor:
    """grouped_xyz (..., S, 3) neighbor offsets (relative to the query),
    found (..., S) bool validity -> (...,) log-density.

    density(q) = logsumexp_j N(offset_j; 0, h^2 I) over valid neighbors,
    minus log(count); 0 where a ball found none.
    """
    d2 = (grouped_xyz ** 2).sum(-1)
    log_kernel = -0.5 * d2 / (bandwidth ** 2) - 1.5 * math.log(
        2 * math.pi * bandwidth ** 2)
    log_kernel = torch.where(found, log_kernel,
                             torch.full_like(log_kernel, -math.inf))
    cnt = torch.clamp(found.sum(-1), min=1)
    out = torch.logsumexp(log_kernel, -1) - torch.log(cnt.to(d2.dtype))
    return torch.where(found.any(-1), out, torch.zeros_like(out))

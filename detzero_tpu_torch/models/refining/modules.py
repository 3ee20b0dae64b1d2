"""Shared bricks of the refining transformers (port of
detzero_tpu/models/refining/modules.py): a learned positional embedding,
the FFN, the post-norm decoder layer with key-padding masks, and the
PointNet encoder.  Plain torch ops on the port's `Linear`, `LayerNorm` and
`MultiHeadDotProductAttention` (flax's numerics, masked logits included);
every tensor carries a leading batch axis where the reference runs one
object a call under vmap.  Submodules keep the reference's parameter
names (flax's auto-names `Dense_<n>`, `FFN_0`), so `convert.
convert_refiner` fills them one to one.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detzero_tpu_torch.models.layers import (
    DenseGeneral, LayerNorm, Linear, MultiHeadDotProductAttention,
    trunc_normal_fan_in,
)


@torch.no_grad()
def init_flax_like(module: nn.Module, generator: torch.Generator):
    """flax's initialisers on every Dense and attention projection of
    `module` (truncated-normal fan-in kernels, zero biases; LayerNorms stay
    identity), drawn from `generator` on the parameters' device.  Not the
    reference's random stream."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.copy_(trunc_normal_fan_in(
                mod.weight.shape, mod.in_features, generator,
                mod.weight.device))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, DenseGeneral):
            mod.kernel.copy_(trunc_normal_fan_in(
                mod.kernel.shape, math.prod(mod.in_shape), generator,
                mod.kernel.device))
            mod.bias.zero_()
    return module


class PositionEmbeddingLearned(nn.Module):
    """MLP over coordinates -> d_model embedding."""

    def __init__(self, cin: int, d_model: int, hidden: int = 128,
                 device=None):
        super().__init__()
        self.Dense_0 = Linear(cin, hidden, device=device)
        self.Dense_1 = Linear(hidden, d_model, device=device)

    def forward(self, coords):
        return self.Dense_1(F.relu(self.Dense_0(coords)))


class FFN(nn.Module):
    """Dense, ReLU, Dense and the residual (dropout 0, as every config
    has it)."""

    def __init__(self, d_model: int, d_ff: int = 256, device=None):
        super().__init__()
        self.Dense_0 = Linear(d_model, d_ff, device=device)
        self.Dense_1 = Linear(d_ff, d_model, device=device)

    def forward(self, x):
        return x + self.Dense_1(F.relu(self.Dense_0(x)))


class DecoderLayer(nn.Module):
    """Self-attention over the queries, cross-attention to the memory, FFN,
    each followed by a post-norm residual (every model has the
    self-attention: the reference's `with_self_attn` is always on).  The
    query and key carry the positional embedding, the value does not."""

    def __init__(self, d_model: int, n_heads: int = 4, d_ff: int = 256,
                 device=None):
        super().__init__()
        self.self_attn = MultiHeadDotProductAttention(d_model, n_heads,
                                                      d_model, device=device)
        self.norm_sa = LayerNorm(d_model, device=device)
        self.cross_attn = MultiHeadDotProductAttention(
            d_model, n_heads, d_model, device=device)
        self.norm_ca = LayerNorm(d_model, device=device)
        self.FFN_0 = FFN(d_model, d_ff, device=device)
        self.norm_ffn = LayerNorm(d_model, device=device)

    def forward(self, query, memory, query_pos=None, memory_pos=None,
                query_mask=None, memory_mask=None):
        """query (B, Q, D), memory (B, M, D); masks bool validity (B, Q) and
        (B, M), True = keep."""
        q = query if query_pos is None else query + query_pos
        sa_mask = None
        if query_mask is not None:
            sa_mask = (query_mask[:, None, None, :]
                       & query_mask[:, None, :, None])
        query = self.norm_sa(query + self.self_attn(q, q, query,
                                                    mask=sa_mask))
        q = query if query_pos is None else query + query_pos
        k = memory if memory_pos is None else memory + memory_pos
        ca_mask = None
        if memory_mask is not None:
            qm = query_mask if query_mask is not None else torch.ones(
                query.shape[:2], dtype=torch.bool, device=query.device)
            ca_mask = qm[:, None, :, None] & memory_mask[:, None, None, :]
        attn = self.cross_attn(q, k, memory, mask=ca_mask)
        query = self.norm_ca(query + attn)
        return self.norm_ffn(self.FFN_0(query))


class PointNetEncoder(nn.Module):
    """Shared MLP (Dense, LayerNorm, ReLU a width) and a max-pool over the
    points.  With `mask`, the masked points pool as -inf and a pool with no
    valid point becomes 0.  The reference's second output, the per-point
    features with the pool concatenated, is read by no model and not
    built."""

    def __init__(self, cin: int, features: Sequence[int] = (64, 128, 256),
                 device=None):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"mlp{i}", Linear(cin, f, device=device))
            self.add_module(f"ln{i}", LayerNorm(f, device=device))
            cin = f

    def forward(self, points, mask=None):
        """points (..., N, F), mask (..., N) or None -> (..., C_out)."""
        x = points.float()
        for i in range(self.n):
            x = F.relu(getattr(self, f"ln{i}")(getattr(self, f"mlp{i}")(x)))
        if mask is not None:
            x = torch.where(mask[..., None], x, -math.inf)
        pooled = x.max(dim=-2).values
        return torch.where(torch.isfinite(pooled), pooled, 0.0)


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None.  Raises when no card is
    there: a refining model never falls back to the CPU unless asked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the refining models build on CUDA unless a "
                           "device is given, and torch finds no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")

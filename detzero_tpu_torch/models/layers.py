"""Shared building blocks, eval mode (port of `detzero_tpu/models/layers.py`).

Parameters and statistics keep the reference's names (`scale`, `bias`,
`mean`, `var`) and stay float32; the compute dtype is a constructor
argument.  Training statistics (masked, all-reduced) wait for the training
slice: `MaskedBatchNorm` here uses its running statistics only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


class AutoNames:
    """flax's auto-naming (`ClassName_<n>` per class, in call order), so the
    port's module tree maps one to one onto the reference's param tree."""

    def __init__(self):
        self.counts = {}

    def __call__(self, cls_name: str) -> str:
        n = self.counts.get(cls_name, 0)
        self.counts[cls_name] = n + 1
        return f"{cls_name}_{n}"


class MaskedBatchNorm(nn.Module):
    """Eval-mode BatchNorm with the affine folded in float32 from the
    running statistics: sc = scale * rsqrt(var + eps), bi = bias - mean*sc."""

    def __init__(self, features: int, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(features, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("mean", torch.zeros(features, **kw))
        self.register_buffer("var", torch.ones(features, **kw))

    def affine(self):
        sc = self.scale * torch.rsqrt(self.var + BN_EPS)
        return sc, self.bias - self.mean * sc

    def forward(self, x, channel_dim: int = -1):
        """y = x * sc + bi in f32, returned in x's dtype."""
        sc, bi = self.affine()
        shape = [1] * x.ndim
        shape[channel_dim] = -1
        return (x.float() * sc.reshape(shape) + bi.reshape(shape)).to(x.dtype)


def trunc_normal_fan_in(shape, fan_in, generator, device=None):
    """flax's variance_scaling(1.0, 'fan_in', 'truncated_normal')."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def same_pads(size: int, k: int, s: int):
    """flax/XLA 'SAME' padding (lo, hi) of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """nn.Conv2d with flax's 'SAME' padding.  At stride 2 SAME pads (0, 1),
    not torch's (1, 1); the padding is computed from the input size."""

    def __init__(self, cin, cout, k, stride=1, bias=False, device=None):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias,
                         device=device)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        ph = same_pads(x.shape[-2], k, s)
        pw = same_pads(x.shape[-1], k, s)
        if ph == pw and ph[0] == ph[1]:
            return F.conv2d(x, self.weight.to(x.dtype), _to(self.bias, x),
                            s, ph[0])
        x = F.pad(x, (*pw, *ph))
        return F.conv2d(x, self.weight.to(x.dtype), _to(self.bias, x), s)


def _to(bias, x):
    return None if bias is None else bias.to(x.dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (kernel = stride, no padding) that computes in
    the input's dtype while its weight stays float32."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  _to(self.bias, x), self.stride)


class ConvBNReLU(nn.Module):
    """2D conv + BN + ReLU on NCHW maps (reference `ConvBNReLU`)."""

    def __init__(self, cin, cout, kernel=3, stride=1, act=True, device=None):
        super().__init__()
        self.Conv_0 = Conv2dSame(cin, cout, kernel, stride, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout, device=device)
        self.act = act

    def forward(self, x):
        x = self.MaskedBatchNorm_0(self.Conv_0(x), channel_dim=1)
        return F.relu(x) if self.act else x

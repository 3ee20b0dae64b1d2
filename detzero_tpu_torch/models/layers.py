"""Shared building blocks (port of `detzero_tpu/models/layers.py`).

Parameters and statistics keep the reference's names (`scale`, `bias`,
`mean`, `var`) and stay float32; the compute dtype is a constructor
argument, or the input's.  `MaskedBatchNorm` follows
`torch.nn.Module.training`: running statistics in eval mode, masked batch
statistics in train mode.  `MLP`, `LayerNorm` and
`MultiHeadDotProductAttention` are the blocks of the PDV RoI head and of
the refining models, with flax's numerics: LayerNorm's epsilon 1e-6 and
its one-pass variance, the attention's query scaled by 1/sqrt(head dim)
and its masked logits set to the dtype's least finite value.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from detzero_tpu_torch.core.mesh import data_group
from detzero_tpu_torch.ops.masked_bn import (BN_EPS, all_reduce_grad_sums,
                                             bn_grad_input, bn_grad_sums,
                                             bn_normalize, masked_bn_stats)

BN_MOMENTUM = 0.99      # running = m * running + (1 - m) * batch


class AutoNames:
    """flax's auto-naming (`ClassName_<n>` per class, in call order), so the
    port's module tree maps one to one onto the reference's param tree."""

    def __init__(self):
        self.counts = {}

    def __call__(self, cls_name: str) -> str:
        n = self.counts.get(cls_name, 0)
        self.counts[cls_name] = n + 1
        return f"{cls_name}_{n}"


class _MaskedBNTrain(torch.autograd.Function):
    """Train-mode BN of the reference (`layers.py:59-99`) in float32:
    `masked_bn_stats`, `bn_normalize`, and the analytic backward
    (`bn_grad_sums`, `bn_grad_input`), the statistics and the sums reaching
    them the global batch's under a process group.  Returns (y in x's
    dtype, mean, var).  Autograd keeps only x, not the float32
    intermediates (at the first level a float32 copy of the table is about
    1 GB)."""

    @staticmethod
    def forward(ctx, x, scale, bias, mask, ch):
        cnt, mean, var, rstd = masked_bn_stats(x, mask, ch)
        ctx.save_for_backward(x, mask, scale, mean, rstd, cnt)
        ctx.ch = ch
        ctx.group = data_group()
        ctx.mark_non_differentiable(mean, var)
        return bn_normalize(x, scale, bias, mean, rstd, ch), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mask, scale, mean, rstd, cnt = ctx.saved_tensors
        sum_g, sum_gx = bn_grad_sums(gy, x, ctx.ch)
        tot_g, tot_gx = all_reduce_grad_sums(sum_g, sum_gx, ctx.group)
        dx = bn_grad_input(gy, x, mask, scale, mean, rstd, cnt, tot_g,
                           tot_gx, ctx.ch)
        return dx, rstd * (sum_gx - mean * sum_g), sum_g, None, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm with a site mask.  Eval mode: the affine folded in float32
    from the running statistics, sc = scale * rsqrt(var + eps),
    bi = bias - mean*sc.  Train mode: masked batch statistics over every
    axis but the channel one (`_MaskedBNTrain`), and the running statistics
    updated with decay 0.99 (no gradient).  The output is not masked: the
    callers zero the empty sites, as the reference does."""

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

    def update_running(self, mean, var):
        """The running statistics after a train-mode batch (decay 0.99)."""
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean
                            + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)

    def forward(self, x, channel_dim: int = -1, mask=None):
        """Returns the normalised x in x's dtype.  mask: bool, broadcastable
        to x with size 1 on the channel axis; read in train mode only."""
        ch = channel_dim % x.ndim
        if self.training:
            m = None if mask is None else mask.to(torch.float32)
            y, mean, var = _MaskedBNTrain.apply(x, self.scale, self.bias, m,
                                                ch)
            self.update_running(mean, var)
            return y
        sc, bi = self.affine()
        shape = [1] * x.ndim
        shape[ch] = -1
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
    """2D conv + BN + ReLU on NCHW maps (reference `ConvBNReLU`); in train
    mode the BN statistics span N*H*W."""

    def __init__(self, cin, cout, kernel=3, stride=1, act=True, device=None):
        super().__init__()
        self.Conv_0 = Conv2dSame(cin, cout, kernel, stride, device=device)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout, device=device)
        self.act = act

    def forward(self, x):
        x = self.MaskedBatchNorm_0(self.Conv_0(x), channel_dim=1)
        return F.relu(x) if self.act else x


class Linear(nn.Linear):
    """nn.Linear (flax `Dense`) that computes in the input's dtype while its
    parameters stay float32."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _to(self.bias, x))


class MLP(nn.Module):
    """Dense (no bias) + MaskedBatchNorm + ReLU per width (reference
    `MLP`): forward(x (..., C), mask (...) or None).  The BN statistics
    come from the rows `mask` marks."""

    def __init__(self, cin, features, device=None):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense{i}", Linear(cin, f, bias=False,
                                                device=device))
            self.add_module(f"bn{i}", MaskedBatchNorm(f, device=device))
            cin = f

    def forward(self, x, mask=None):
        m = None if mask is None else mask[..., None]
        for i in range(self.n):
            x = getattr(self, f"dense{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x, mask=m))
        return x


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis: float32 statistics with the
    one-pass variance max(E[x^2] - E[x]^2, 0), epsilon 1e-6; the output in
    the input's dtype."""

    def __init__(self, features, eps=1e-6, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(features, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


class DenseGeneral(nn.Module):
    """flax `DenseGeneral` with the kernel kept in flax's layout:
    in_shape + out_shape, contracting the input's trailing in_shape axes."""

    def __init__(self, in_shape, out_shape, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.zeros(self.in_shape + self.out_shape,
                                               **kw))
        self.bias = nn.Parameter(torch.zeros(self.out_shape, **kw))

    def forward(self, x):
        k_in = math.prod(self.in_shape)
        lead = x.shape[:x.ndim - len(self.in_shape)]
        y = x.reshape(-1, k_in) @ self.kernel.to(x.dtype).reshape(k_in, -1)
        return y.reshape(*lead, *self.out_shape) + self.bias.to(x.dtype)


class MultiHeadDotProductAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention` (no dropout): query, key and
    value projections to (heads, head_dim), the query scaled by
    1/sqrt(head_dim), softmax over the keys, and the output projection
    back to the input width.  forward(q (..., L, C), k, v, mask=None).

    `mask`, bool and broadcastable to (..., heads, L_q, L_k), keeps flax's
    semantics: a masked logit becomes finfo(dtype).min before the softmax,
    so a row with every key masked gets uniform weights over all keys, not
    NaN (`scaled_dot_product_attention` with a boolean mask gives NaN
    there, and the refining losses multiply such rows by 0)."""

    def __init__(self, features, num_heads, qkv_features, device=None):
        super().__init__()
        self.heads = num_heads
        self.head_dim = qkv_features // num_heads
        hd = (num_heads, self.head_dim)
        self.query = DenseGeneral((features,), hd, device=device)
        self.key = DenseGeneral((features,), hd, device=device)
        self.value = DenseGeneral((features,), hd, device=device)
        self.out = DenseGeneral(hd, (features,), device=device)

    def forward(self, inputs_q, inputs_k, inputs_v, mask=None):
        q = self.query(inputs_q) / math.sqrt(self.head_dim)
        k, v = self.key(inputs_k), self.value(inputs_v)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, -1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", w, v))

"""Shared building blocks (port of `detzero_tpu/models/layers.py`).

Parameters and statistics keep the reference's names (`scale`, `bias`,
`mean`, `var`) and stay float32; the compute dtype is a constructor
argument.  `MaskedBatchNorm` follows `torch.nn.Module.training`: running
statistics in eval mode, masked batch statistics in train mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
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


def _stat_dims(x, ch):
    return tuple(d for d in range(x.ndim) if d != ch)


class _MaskedBNTrain(torch.autograd.Function):
    """Train-mode BN of the reference (`layers.py:59-99`) in float32: the
    statistics come from the sites `mask` marks (every site when None), the
    variance is the biased max(E[x^2] - mean^2, 0), and the gradient flows
    through mean and variance, as flax differentiates it.  Returns
    (y in x's dtype, mean, var).  The backward is the analytic one, so
    autograd keeps only x, not the float32 intermediates (at the first
    level a float32 copy of the table is about 1 GB)."""

    @staticmethod
    def forward(ctx, x, scale, bias, mask, ch):
        dims = _stat_dims(x, ch)
        shape = [1] * x.ndim
        shape[ch] = -1
        xf = x.float()
        if mask is None:
            cnt = torch.tensor(float(x.numel() // x.shape[ch]),
                               device=x.device)
            s, ss = xf.sum(dims), (xf * xf).sum(dims)
        else:
            xm = xf * mask
            cnt = mask.sum(dtype=torch.float32)
            s, ss = xm.sum(dims), (xm * xf).sum(dims)
            del xm
        cnt = torch.clamp(cnt, min=1.0)
        mean = s / cnt
        var = torch.clamp(ss / cnt - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + BN_EPS)
        y = (xf - mean.reshape(shape)) * rstd.reshape(shape)
        y = y * scale.reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(x, mask, scale, mean, rstd, cnt)
        ctx.ch = ch
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mask, scale, mean, rstd, cnt = ctx.saved_tensors
        ch = ctx.ch
        dims = _stat_dims(x, ch)
        shape = [1] * x.ndim
        shape[ch] = -1
        g = gy.float()
        xf = x.float()
        sum_g = g.sum(dims)
        # sum of g * xhat with xhat = (x - mean) * rstd
        sum_gxhat = rstd * ((g * xf).sum(dims) - mean * sum_g)
        a = scale * rstd
        d_var = -0.5 * scale * rstd * rstd * sum_gxhat
        d_mean = -a * sum_g - 2.0 * mean * d_var
        # mean = sum(m x) / cnt and E[x^2] = sum(m x^2) / cnt
        per = (d_mean.reshape(shape) + 2.0 * xf * d_var.reshape(shape)) / cnt
        if mask is not None:
            per = per * mask
        dx = a.reshape(shape) * g + per
        return dx.to(x.dtype), sum_gxhat, sum_g, None, None


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

    def forward(self, x, channel_dim: int = -1, mask=None):
        """Returns the normalised x in x's dtype.  mask: bool, broadcastable
        to x with size 1 on the channel axis; read in train mode only."""
        ch = channel_dim % x.ndim
        if self.training:
            m = None if mask is None else mask.to(torch.float32)
            y, mean, var = _MaskedBNTrain.apply(x, self.scale, self.bias, m,
                                                ch)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var)
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

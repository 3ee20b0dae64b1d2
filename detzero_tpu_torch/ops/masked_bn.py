"""The steps of train-mode batch normalisation over masked sites (the
reference's `layers.py:59-99`), float32, shared by `MaskedBatchNorm`
(`models/layers.py`) and the plain version of kernel K11
(`ops/rowpad_bn.py`): the batch statistics, the affine, the sums of the
output gradient and the input gradient, with the all-reduces of a process
group (core/mesh.py)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from detzero_tpu_torch.core.mesh import data_group

BN_EPS = 1e-3


def _stat_dims(x, ch):
    return tuple(d for d in range(x.ndim) if d != ch)


def masked_bn_stats(x, mask, ch):
    """The batch statistics of train-mode BN (`layers.py:59-99` of the
    reference), float32: (cnt, mean, var, rstd) from the sites `mask`
    marks (every site when None), the variance the biased max(E[x^2] -
    mean^2, 0).  Under a process group (core/mesh.py) they are the global
    batch's: one all-reduce of the packed (cnt, s, ss), as the reference
    psums them."""
    dims = _stat_dims(x, ch)
    xf = x.float()
    if mask is None:
        cnt = torch.tensor(float(x.numel() // x.shape[ch]), device=x.device)
        s, ss = xf.sum(dims), (xf * xf).sum(dims)
    else:
        xm = xf * mask
        cnt = mask.sum(dtype=torch.float32)
        s, ss = xm.sum(dims), (xm * xf).sum(dims)
        del xm
    group = data_group()
    if group is not None:
        c = s.shape[0]
        packed = torch.cat([cnt.reshape(1), s, ss])
        dist.all_reduce(packed, group=group)
        cnt, s, ss = packed[0], packed[1:c + 1], packed[c + 1:]
    cnt = torch.clamp(cnt, min=1.0)
    mean = s / cnt
    var = torch.clamp(ss / cnt - mean * mean, min=0.0)
    return cnt, mean, var, torch.rsqrt(var + BN_EPS)


def _channel_shape(x, ch):
    shape = [1] * x.ndim
    shape[ch] = -1
    return shape


def bn_normalize(x, scale, bias, mean, rstd, ch):
    """((x - mean) * rstd) * scale + bias in float32, returned in x's
    dtype."""
    shape = _channel_shape(x, ch)
    y = (x.float() - mean.reshape(shape)) * rstd.reshape(shape)
    y = y * scale.reshape(shape) + bias.reshape(shape)
    return y.to(x.dtype)


def bn_grad_sums(gy, x, ch):
    """(sum g, sum g x) per channel, float32, of the output gradient."""
    dims = _stat_dims(x, ch)
    g = gy.float()
    return g.sum(dims), (g * x.float()).sum(dims)


def bn_grad_input(gy, x, mask, scale, mean, rstd, cnt, tot_g, tot_gx, ch):
    """The input gradient of train-mode BN, in x's dtype, from the sums
    (`tot_g`, `tot_gx`) that reach the statistics: the gradient flows
    through mean and variance, as flax differentiates it."""
    shape = _channel_shape(x, ch)
    g = gy.float()
    xf = x.float()
    # sum of g * xhat with xhat = (x - mean) * rstd
    tot_gxhat = rstd * (tot_gx - mean * tot_g)
    a = scale * rstd
    d_var = -0.5 * scale * rstd * rstd * tot_gxhat
    d_mean = -a * tot_g - 2.0 * mean * d_var
    # mean = sum(m x) / cnt and E[x^2] = sum(m x^2) / cnt
    per = (d_mean.reshape(shape) + 2.0 * xf * d_var.reshape(shape)) / cnt
    if mask is not None:
        per = per * mask
    dx = a.reshape(shape) * g + per
    return dx.to(x.dtype)


def all_reduce_grad_sums(sum_g, sum_gx, group):
    """Mean and variance are the global batch's, so every rank's outputs
    move them: the gradient reaching them is the sum over ranks, one
    all-reduce of the packed (sum_g, sum_gx).  The scale and bias
    gradients stay this rank's share (the trainer averages the parameters'
    gradients)."""
    if group is None:
        return sum_g, sum_gx
    c = sum_g.shape[0]
    packed = torch.cat([sum_g, sum_gx])
    dist.all_reduce(packed, group=group)
    return packed[:c], packed[c:]

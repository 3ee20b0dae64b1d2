"""Kernel K11: the train-mode epilogue of the row-pad 3x3x3 convs
(`rowpad_bn`, `csrc/rowpad_bn.cu`).  It replaces no TPU kernel: the JAX
package leaves this glue to XLA's fusion.

After each training conv, `SparseConvBNReLU` normalises the conv output y
(ny, onz*C, B) with the masked batch statistics of its occupied sites,
applies the affine, the ReLU (`act`), zeroes the empty sites, and for the
second conv of a residual block adds the skip and applies the final ReLU.
As torch ops that was some 15 float32 passes over the dense table forward
and 25 backward; `RowpadBN` does it in two passes each way (statistics,
then apply; gradient sums, then input gradient), each a kernel over the
table and a small fixed-order reduction, with the statistics' all-reduce
between the two under a process group.  See the source for the design.

The plain version is that composition as it was, op for op (the masked BN
of `models/layers.py`, `torch.relu`, `torch.where`, the residual add and
their autograd backwards): `RowpadBN` takes it for CPU tensors and gives
the same bits.  For CUDA tensors it launches the kernels or raises.  The
kernels read and write the table's dtype, bf16 or float32 (float32 for the
card-vs-CPU gradient check of a float32 model, as K4 does), and sum in
float32.  Their sums are taken in another order than the plain version's;
fed the same statistics, the apply kernels give its values.

The backward reads only y, the output and the zmask: every ReLU of this
path masks by out > 0, so the gradient reaching the BN is g_out [out > 0] m.
That does not hold for an `act` conv with a residual (its inner ReLU's mask
is not out > 0), which no backbone has and `rowpad_bn` refuses.

`LAUNCHES` counts kernel launches (three each way); `FORWARDS` and
`BACKWARDS` the `RowpadBN` forwards and backwards on any device, which is
how often the fused epilogue engages: 20 each in a one-stage training step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from detzero_tpu_torch import _build
from detzero_tpu_torch.core.mesh import data_group
from detzero_tpu_torch.ops.masked_bn import (all_reduce_grad_sums,
                                             bn_grad_input, bn_grad_sums,
                                             bn_normalize, masked_bn_stats)

LAUNCHES = 0
FORWARDS = 0
BACKWARDS = 0
# rows of the statistics kernels' partial sums: one block a run of lines;
# fixed, so that the order of the sums depends on the shape alone
MAX_SUM_BLOCKS = 1024


def sum_chain(lines, b):
    """The longest chain of float32 additions behind one of the kernels'
    sums over `lines` (row, z) lines of B slots: a thread's run of lines
    (8 slots each), the block's slot groups, the reduction's strided rows
    and its 32 partials.  Each sum lies within chain * 2^-24 of the sum of
    its terms' magnitudes."""
    lpb = -(-lines // MAX_SUM_BLOCKS)
    return lpb * 8 + b // 8 + -(-MAX_SUM_BLOCKS // 32) + 32


def _views(t, zmask, cout):
    """(ny, onz*C, B) -> the (ny, onz, C, B) view and its site mask
    (ny, onz, 1, B)."""
    ny, w, b = t.shape
    onz = w // cout
    return t.reshape(ny, onz, cout, b), zmask[:, :onz, None, :]


# ---------------------------------------------------------------------------
# the plain version: the torch composition
# ---------------------------------------------------------------------------

def apply_plain(y, zmask, scale, bias, mean, rstd, residual, act, cout):
    """The forward's elementwise part from the statistics: BN in float32,
    rounded to y's dtype, ReLU if `act`, zero at the empty sites, then
    relu(out + residual) with a residual."""
    x4, m4 = _views(y, zmask, cout)
    out = bn_normalize(x4, scale, bias, mean, rstd, 2)
    if act:
        out = torch.relu(out)
    out = torch.where(m4, out, 0.0).reshape(y.shape)
    if residual is not None:
        out = torch.relu(out + residual.to(out.dtype))
    return out


def grad_bn_plain(g_out, out, zmask, relu_mask, cout):
    """The gradient reaching the BN's output (autograd's backwards of the
    ReLUs and the `where`) and the residual's (before its cast)."""
    g = torch.where(out <= 0, 0.0, g_out) if relu_mask else g_out
    g4, m4 = _views(g, zmask, cout)
    return torch.where(m4, g4, 0.0), g


def grad_apply_plain(g_out, out, y, zmask, scale, mean, rstd, cnt, tot_g,
                     tot_gx, relu_mask, cout):
    """The input gradient of y and the residual's, from the summed
    statistics (`tot_g`, `tot_gx`)."""
    g_bn, d_res = grad_bn_plain(g_out, out, zmask, relu_mask, cout)
    x4, m4 = _views(y, zmask, cout)
    dx = bn_grad_input(g_bn, x4, m4.to(torch.float32), scale, mean, rstd,
                       cnt, tot_g, tot_gx, 2)
    return dx.reshape(y.shape), d_res


def _forward_plain(y, zmask, scale, bias, residual, act, cout):
    x4, m4 = _views(y, zmask, cout)
    cnt, mean, var, rstd = masked_bn_stats(x4, m4.to(torch.float32), 2)
    out = apply_plain(y, zmask, scale, bias, mean, rstd, residual, act, cout)
    return out, torch.stack([mean, var, rstd, cnt.expand_as(rstd)])


def _backward_plain(g_out, out, y, zmask, scale, stats, relu_mask, group,
                    cout):
    mean, rstd, cnt = stats[0], stats[2], stats[3, 0]
    g_bn, _ = grad_bn_plain(g_out, out, zmask, relu_mask, cout)
    sum_g, sum_gx = bn_grad_sums(g_bn, _views(y, zmask, cout)[0], 2)
    tot_g, tot_gx = all_reduce_grad_sums(sum_g, sum_gx, group)
    dx, d_res = grad_apply_plain(g_out, out, y, zmask, scale, mean, rstd,
                                 cnt, tot_g, tot_gx, relu_mask, cout)
    return dx, d_res, rstd * (sum_gx - mean * sum_g), sum_g


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(name, y, zmask, cout, *tables):
    """Raise unless the tensors fit the kernels' contract (the kernels
    refuse a geometry they cannot take); -> (ny, onz, B, zm_nz, f32)."""
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the kernels take bf16 or float32 tables, "
                         f"got {y.dtype}")
    ny, w, b = y.shape
    onz = w // cout if cout > 0 else 0
    if w != onz * cout or onz < 1:
        raise ValueError(f"{name}: table {tuple(y.shape)} is not onz * C "
                         f"with C={cout}")
    if (zmask.dtype != torch.bool or zmask.dim() != 3
            or zmask.shape[0] != ny or zmask.shape[1] < onz
            or zmask.shape[2] != b):
        raise ValueError(f"{name}: zmask {tuple(zmask.shape)} "
                         f"{zmask.dtype} for table {tuple(y.shape)}")
    for t in tables:
        if t.shape != y.shape or t.dtype != y.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} beside "
                             f"table {tuple(y.shape)} {y.dtype}")
    _build.require_cuda(name, y, zmask, *tables)
    if any(t.data_ptr() % 16 for t in (y,) + tables) or zmask.data_ptr() % 8:
        raise ValueError(f"{name}: tables must be 16-byte aligned")
    return ny, onz, b, zmask.shape[1], int(y.dtype == torch.float32)


def rowpad_bn_stats(y, zmask, cout):
    """K11's statistics pass: (2C + 1,) float32 (cnt, sum m y, sum m y^2)
    over the occupied sites, in a fixed order."""
    ny, onz, b, zm_nz, f32 = _check("rowpad_bn_stats", y, zmask, cout)
    ncol = 2 * cout + 1
    buf = torch.empty((MAX_SUM_BLOCKS + 1) * ncol, dtype=torch.float32,
                      device=y.device)
    packed = buf[MAX_SUM_BLOCKS * ncol:]
    rc = _build.lib().dz_rowpad_bn_stats(
        y.data_ptr(), zmask.data_ptr(), buf.data_ptr(), packed.data_ptr(),
        ny, onz, cout, b, zm_nz, MAX_SUM_BLOCKS, f32,
        _build.stream_ptr(y.device))
    global LAUNCHES
    LAUNCHES += 2
    _build.check(rc, "dz_rowpad_bn_stats")
    return packed


def rowpad_bn_apply(y, zmask, scale, bias, packed, residual, act, cout):
    """K11's apply pass -> (out, stats (4, C): mean, var, rstd, cnt), the
    statistics derived from `packed`."""
    res = () if residual is None else (residual,)
    ny, onz, b, zm_nz, f32 = _check("rowpad_bn_apply", y, zmask, cout, *res)
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _build.require_cuda("rowpad_bn_apply", y, scale, bias, packed)
    out = torch.empty_like(y)
    stats = torch.empty((4, cout), dtype=torch.float32, device=y.device)
    rc = _build.lib().dz_rowpad_bn_apply(
        y.data_ptr(), zmask.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        packed.data_ptr(), residual.data_ptr() if res else None,
        out.data_ptr(), stats.data_ptr(), ny, onz, cout, b, zm_nz, int(act),
        f32, _build.stream_ptr(y.device))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(rc, "dz_rowpad_bn_apply")
    return out, stats


def rowpad_bn_grad_sums(g_out, out, y, zmask, relu_mask, cout):
    """K11's backward reduce pass: (2C,) float32 (sum g_bn, sum g_bn y)."""
    ny, onz, b, zm_nz, f32 = _check("rowpad_bn_grad_sums", y, zmask, cout,
                                    g_out, out)
    ncol = 2 * cout
    buf = torch.empty((MAX_SUM_BLOCKS + 1) * ncol, dtype=torch.float32,
                      device=y.device)
    packed = buf[MAX_SUM_BLOCKS * ncol:]
    rc = _build.lib().dz_rowpad_bn_grad_sums(
        g_out.data_ptr(), out.data_ptr(), y.data_ptr(), zmask.data_ptr(),
        buf.data_ptr(), packed.data_ptr(), ny, onz, cout, b, zm_nz,
        MAX_SUM_BLOCKS, int(relu_mask), f32, _build.stream_ptr(y.device))
    global LAUNCHES
    LAUNCHES += 2
    _build.check(rc, "dz_rowpad_bn_grad_sums")
    return packed


def rowpad_bn_grad_apply(g_out, out, y, zmask, scale, stats, local, tot,
                         with_residual, relu_mask, cout):
    """K11's backward apply pass -> (dx, d_res or None, grads (2, C): the
    scale and bias gradients from `local`); the input gradient's
    coefficients come from `tot`."""
    ny, onz, b, zm_nz, f32 = _check("rowpad_bn_grad_apply", y, zmask, cout,
                                    g_out, out)
    scale = scale.float().contiguous()
    _build.require_cuda("rowpad_bn_grad_apply", y, scale, stats, local, tot)
    dx = torch.empty_like(y)
    d_res = torch.empty_like(y) if with_residual else None
    grads = torch.empty((2, cout), dtype=torch.float32, device=y.device)
    rc = _build.lib().dz_rowpad_bn_grad_apply(
        g_out.data_ptr(), out.data_ptr(), y.data_ptr(), zmask.data_ptr(),
        scale.data_ptr(), stats.data_ptr(), local.data_ptr(), tot.data_ptr(),
        dx.data_ptr(), d_res.data_ptr() if with_residual else None,
        grads.data_ptr(), ny, onz, cout, b, zm_nz,
        int(relu_mask), f32, _build.stream_ptr(y.device))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(rc, "dz_rowpad_bn_grad_apply")
    return dx, d_res, grads


class RowpadBN(torch.autograd.Function):
    """(out, mean, var) of the train-mode epilogue; see the module
    docstring.  mean and var are the batch statistics, for the running
    ones; no gradient flows through them or the zmask."""

    @staticmethod
    def forward(ctx, y, scale, bias, zmask, residual, act, cout):
        global FORWARDS
        FORWARDS += 1
        group = data_group()
        if y.device.type == "cpu":
            out, stats = _forward_plain(y, zmask, scale, bias, residual, act,
                                        cout)
        else:
            y = y.contiguous()
            zmask = zmask.contiguous()
            if residual is not None:
                residual = residual.to(y.dtype).contiguous()
            packed = rowpad_bn_stats(y, zmask, cout)
            if group is not None:
                dist.all_reduce(packed, group=group)
            out, stats = rowpad_bn_apply(y, zmask, scale, bias, packed,
                                         residual, act, cout)
        mean, var = stats[0], stats[1]
        ctx.save_for_backward(y, out, zmask, scale, stats)
        ctx.meta = (act or residual is not None, cout, group,
                    None if residual is None else residual.dtype)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g_out, _gmean, _gvar):
        global BACKWARDS
        BACKWARDS += 1
        y, out, zmask, scale, stats = ctx.saved_tensors
        relu_mask, cout, group, res_dtype = ctx.meta
        if y.device.type == "cpu":
            dx, d_res, d_scale, d_bias = _backward_plain(
                g_out, out, y, zmask, scale, stats, relu_mask, group, cout)
        else:
            g_out = g_out.to(y.dtype).contiguous()
            local = rowpad_bn_grad_sums(g_out, out, y, zmask, relu_mask,
                                        cout)
            tot = local
            if group is not None:
                tot = local.clone()
                dist.all_reduce(tot, group=group)
            dx, d_res, grads = rowpad_bn_grad_apply(
                g_out, out, y, zmask, scale, stats, local, tot,
                res_dtype is not None, relu_mask, cout)
            d_scale, d_bias = grads[0], grads[1]
        if res_dtype is not None and ctx.needs_input_grad[4]:
            d_res = d_res.to(res_dtype)
        else:
            d_res = None
        return dx, d_scale, d_bias, None, d_res, None, None


def rowpad_bn(y, zmask, scale, bias, residual=None, *, act, cout):
    """The train-mode epilogue of a row-pad conv: y (ny, onz*C, B) the conv
    output in the table's dtype, zmask (ny, >= onz, B) bool the output
    level's, scale and bias (C,) float32 the BN's parameters, residual None
    or y's shape.  Returns (out in y's dtype, the batch mean, the batch
    var)."""
    if act and residual is not None:
        raise ValueError("rowpad_bn: an act conv with a residual has a ReLU "
                         "mask that the output does not give")
    return RowpadBN.apply(y, scale, bias, zmask, residual, bool(act),
                          int(cout))

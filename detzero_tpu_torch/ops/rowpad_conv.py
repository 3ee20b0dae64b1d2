"""Row-padded sparse 3x3x3 convs:

  * kernel K2, eval mode: out = relu(conv(table) * scale + bias
    [+ residual]) * zmask (`rowpad_conv_fused`, replaces
    `detzero_tpu/ops/pallas_pillar.py::rowpad_conv_fused`);
  * kernel K4, the conv alone in 'subm', 'down' and 'up' mode
    (`rowpad_conv`, replaces `pallas_pillar.rowpad_conv`).  K2 and K4 are
    one templated kernel in `csrc/rowpad_conv.cu`, as the reference runs
    both through one `_conv_kernel`;
  * kernel K5, the conv's weight gradient (`rowpad_conv_dw`, replaces
    `pallas_pillar.rowpad_conv_dw`, `csrc/rowpad_conv_dw.cu`);
  * kernel K9, K4's 'subm' conv with z stride 1 that streams its source
    rows through shared memory (`rowpad_conv_sliding`, replaces
    `pallas_pillar.rowpad_conv_sliding`, `csrc/rowpad_conv_sliding.cu`);
    bf16 only, on the tensor cores in K4's order of summation, so equal to
    K4 bit for bit;
  * `RowpadConv`, the training conv with the scatter-free backward of
    `pallas_pillar.make_conv_op`: the input gradient is K4 with the flipped
    weight ('up' mode for a strided conv), the weight gradient is K5.  With
    `USE_SLIDING` (`DETZERO_SLIDING_CONV=1`, as `pallas_pillar.USE_SLIDING`)
    its forward 'subm' conv with z stride 1 is K9 instead of K4.

On the flagship scene about one voxel in fifty is occupied, so what bounds
the conv kernels on the H100 is writing the output table, not the
arithmetic.  K2, the bf16 K4, K5 and K9 compact each row's occupied sites
in shared memory and run the products on the tensor cores (`mma.sync`
bf16, f32 sums): K2, K4 and K5 gather the taps by rank from device memory,
K9 from source-row slabs it copies into shared memory with `cp.async`; the
float32 K4 keeps one thread per site on the CUDA cores.  See the sources.

Tensor contract (the reference's, with the spconv-order weight):
  table    (ny_in, nz*cin, B_in)
  nbr      (ny_out, 16, B_out) int32; rows 0..8 = rank of tap j's neighbour
           inside its source row (y+dy for 'subm', 2y+dy for 'down',
           floor((y+dy)/2) for 'up'), >= B_in when absent
  weight   (27, cin, cout), k = ((dz+1)*3 + (dy+1))*3 + (dx+1)
  scale, bias (cout,) f32 folded BN affine (K2 only)
  zmask    (ny_out, out_nz, B_out) bool
  residual (ny_out, out_nz*cout, B_out) or None (K2 only)
Returns (ny_out, out_nz*cout, B_out); K5 returns (27, cin, cout) f32.

Every wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version for CPU tensors.  The kernels read bf16 and sum in f32, as
the TPU kernels compute whatever the model's dtype; the plain versions
compute in f32 from the values given.  One exception: K4 reads and writes
float32 tables when it is given them, so a float32 model on the card
trains its convs in float32 (and serves them in bf16, through K2).  That
departs from the TPU kernel and exists only so that a float32 model on the
card can be held to the CPU reference gradient: at random init bf16
rounding alone moves this model's gradient too far for any leaf-by-leaf
comparison.  `LAUNCHES` counts K2's launches, `CONV_LAUNCHES` K4's,
`DW_LAUNCHES` K5's and `SLIDING_LAUNCHES` K9's.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from detzero_tpu_torch import _build
from detzero_tpu_torch.ops.pillars import NBR_ROWS, zconv_matmul

LAUNCHES = 0
CONV_LAUNCHES = 0
DW_LAUNCHES = 0
SLIDING_LAUNCHES = 0
_MODES = {"subm": 0, "down": 1, "up": 2}
# output rows per K5 block: few, so that a launch has thousands of blocks
# to hide the gathers' latency (each chunk adds a (27, cin, cout) f32
# partial sum to the workspace)
DW_ROWS_PER_CHUNK = 3
# consecutive output rows one K9 block walks (one: the flagship's L3 has
# only 376 rows, and a block per row keeps the card full)
SLIDING_ROWS_PER_STRIP = 1
# K9's transposed weight pads cin to a multiple of this: the 16 input
# channels a kernel stage copies
SLIDING_CIN_ALIGN = 16
# RowpadConv's forward 'subm' conv with z stride 1 runs K9 instead of K4;
# read at call time
USE_SLIDING = os.environ.get("DETZERO_SLIDING_CONV", "0") == "1"


def _out_nz(nz, z_stride, out_nz):
    return out_nz if out_nz is not None else (nz - 1) // z_stride + 1


def _gather_taps(table, nbr, *, nz, cin, mode):
    """The 9 BEV taps of every output slot by rank, as f32 (N, nz, 9*cin)
    with N = ny_out * b_out (slot-major), zeros where a tap is absent.  In
    'up' mode the table holds nz // 2 planes that land on even z."""
    ny_in, w_in, b_in = table.shape
    ny_out, _, b_out = nbr.shape
    flat = table.permute(0, 2, 1).reshape(ny_in * b_in, w_in).float()
    if mode == "up":
        half = flat.reshape(-1, nz // 2, 1, cin)
        flat = torch.cat([half, torch.zeros_like(half)], 2).reshape(-1,
                                                                    nz * cin)
    out_row = torch.arange(ny_out * b_out, device=table.device) // b_out
    nbr_flat = nbr.permute(0, 2, 1).reshape(ny_out * b_out, -1).long()
    parts = []
    for j in range(9):
        dy = j // 3 - 1
        if mode == "subm":
            src = out_row + dy
        elif mode == "down":
            src = 2 * out_row + dy
        else:
            src = torch.div(out_row + dy, 2, rounding_mode="floor")
        src = torch.clamp(src, 0, ny_in - 1)
        rank = nbr_flat[:, j]
        fnd = (rank >= 0) & (rank < b_in)
        g = flat[torch.where(fnd, src * b_in + rank, 0)].reshape(-1, nz, cin)
        parts.append(torch.where(fnd[:, None, None], g, 0.0))
    return torch.cat(parts, -1)


def rowpad_conv_fused_plain(table, nbr, weight, scale, bias, zmask,
                            residual=None, *, nz, cin, cout, z_stride=1,
                            out_nz=None, mode="subm", relu=True):
    """Gather the 9 BEV taps by rank, z-conv them as one matmul, apply the
    epilogue.  Computes in f32 from the inputs' values (the weight is first
    rounded to the table's dtype, as the kernel sees it)."""
    if mode not in ("subm", "down"):
        raise ValueError(f"rowpad_conv_fused: mode {mode!r}")
    ny_out, _, b_out = nbr.shape
    onz = _out_nz(nz, z_stride, out_nz)
    g = _gather_taps(table, nbr, nz=nz, cin=cin, mode=mode)
    w3 = weight.to(table.dtype).float().reshape(3, 9 * cin, cout)
    acc = zconv_matmul(g, w3, z_stride, onz)            # (N, onz, cout)
    y = acc * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.float().reshape(ny_out, onz, cout, b_out).permute(
            0, 3, 1, 2).reshape(-1, onz, cout)
    if relu:
        y = torch.clamp(y, min=0.0)
    zm = zmask[:, :onz].permute(0, 2, 1).reshape(-1, onz, 1)
    y = torch.where(zm, y, 0.0)
    y = y.reshape(ny_out, b_out, onz * cout).permute(0, 2, 1)
    return y.contiguous().to(table.dtype)


def rowpad_conv_fused(table, nbr, weight, scale, bias, zmask, residual=None,
                      *, nz, cin, cout, z_stride=1, out_nz=None,
                      mode="subm", relu=True):
    """Kernel K2 on CUDA tensors, its plain version on CPU tensors."""
    if table.device.type == "cpu":
        return rowpad_conv_fused_plain(
            table, nbr, weight, scale, bias, zmask, residual, nz=nz,
            cin=cin, cout=cout, z_stride=z_stride, out_nz=out_nz, mode=mode,
            relu=relu)
    if mode not in ("subm", "down"):
        raise ValueError(f"rowpad_conv_fused: mode {mode!r}")
    ny_in, w_in, b_in = table.shape
    ny_out, nrows, b_out = nbr.shape
    onz = _out_nz(nz, z_stride, out_nz)
    if w_in != nz * cin or nrows != NBR_ROWS or weight.shape != (27, cin,
                                                                 cout):
        raise ValueError(f"rowpad_conv_fused: table {tuple(table.shape)}, "
                         f"nbr {tuple(nbr.shape)}, weight "
                         f"{tuple(weight.shape)} do not fit nz={nz}, "
                         f"cin={cin}, cout={cout}")
    bf = torch.bfloat16
    table = table.to(bf).contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    w = weight.to(bf).contiguous()
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    zm = zmask[:, :onz].to(torch.uint8).contiguous()
    if zm.shape != (ny_out, onz, b_out) or scale.shape != (cout,) \
            or bias.shape != (cout,):
        raise ValueError(f"rowpad_conv_fused: zmask {tuple(zmask.shape)}, "
                         f"scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)}")
    tensors = [table, nbr, w, scale, bias, zm]
    if residual is not None:
        residual = residual.to(bf).contiguous()
        if residual.shape != (ny_out, onz * cout, b_out):
            raise ValueError(f"rowpad_conv_fused: residual "
                             f"{tuple(residual.shape)}")
        tensors.append(residual)
    _build.require_cuda("rowpad_conv_fused", *tensors)
    if cout % 16:
        raise ValueError(f"rowpad_conv_fused: the kernel takes cout in "
                         f"multiples of 16, got {cout}")
    out = torch.empty((ny_out, onz * cout, b_out), dtype=bf,
                      device=table.device)
    rc = _build.lib().dz_rowpad_conv_fused(
        table.data_ptr(), nbr.data_ptr(), w.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), zm.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), ny_in, nz, cin, b_in, ny_out, onz, cout, b_out,
        int(mode == "down"), z_stride, int(relu),
        _build.stream_ptr(table.device))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(rc, "dz_rowpad_conv_fused")
    return out


# ---------------------------------------------------------------------------
# K4 and K5: the training conv and its weight gradient
# ---------------------------------------------------------------------------

def _check_train_args(name, table, nbr, nz, cin, mode, z_stride):
    if mode not in _MODES:
        raise ValueError(f"{name}: mode {mode!r}")
    planes = nz // 2 if mode == "up" else nz
    if (mode == "up" or z_stride == 2) and nz % 2:
        raise ValueError(f"{name}: mode {mode!r} with z_stride {z_stride} "
                         f"needs an even nz, got {nz}")
    if table.shape[1] != planes * cin or nbr.shape[1] != NBR_ROWS:
        raise ValueError(f"{name}: table {tuple(table.shape)}, nbr "
                         f"{tuple(nbr.shape)} do not fit nz={nz}, cin={cin}, "
                         f"mode={mode!r}")


def sliding_weight(weight, cin, cout):
    """K9's weight layout: (27, cin, cout) -> (27, cout, cinp) bf16, each
    tap's matrix transposed so that a kernel stage copies an output
    channel's input channels as one run, zero past cin up to cinp, the
    multiple of SLIDING_CIN_ALIGN."""
    cinp = -(-cin // SLIDING_CIN_ALIGN) * SLIDING_CIN_ALIGN
    wt = weight.to(torch.bfloat16).reshape(27, cin, cout).transpose(1, 2)
    return F.pad(wt, (0, cinp - cin)).contiguous()


def rowpad_conv_sliding(table, nbr, weight, zmask=None, *, nz, cin, cout):
    """Kernel K9 on CUDA tensors: K4's 'subm' conv with z stride 1, bf16
    tables only, returning bf16; on CPU tensors K4's plain version in
    'subm' (f32 out).  Contract of `rowpad_conv_plain`."""
    if table.device.type == "cpu":
        return rowpad_conv_plain(table, nbr, weight, zmask, nz=nz, cin=cin,
                                 cout=cout, mode="subm")
    _check_train_args("rowpad_conv_sliding", table, nbr, nz, cin, "subm", 1)
    ny, _, b_in = table.shape
    b_out = nbr.shape[2]
    if nbr.shape[0] != ny or weight.shape != (27, cin, cout):
        raise ValueError(f"rowpad_conv_sliding: table {tuple(table.shape)}, "
                         f"nbr {tuple(nbr.shape)}, weight "
                         f"{tuple(weight.shape)} for cin={cin}, cout={cout}")
    if table.dtype != torch.bfloat16:
        raise ValueError(f"rowpad_conv_sliding: the kernel reads bf16 tables "
                         f"only, got {table.dtype}")
    if cout % 16:
        raise ValueError(f"rowpad_conv_sliding: the kernel takes cout in "
                         f"multiples of 16, got {cout}")
    table = table.contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    wt = sliding_weight(weight, cin, cout)
    tensors = [table, nbr, wt]
    zm = None
    if zmask is not None:
        zm = zmask[:, :nz].to(torch.uint8).contiguous()
        if zm.shape != (ny, nz, b_out):
            raise ValueError(f"rowpad_conv_sliding: zmask "
                             f"{tuple(zmask.shape)}")
        tensors.append(zm)
    _build.require_cuda("rowpad_conv_sliding", *tensors)
    out = torch.empty((ny, nz * cout, b_out), dtype=torch.bfloat16,
                      device=table.device)
    rc = _build.lib().dz_rowpad_conv_sliding(
        table.data_ptr(), nbr.data_ptr(), wt.data_ptr(),
        zm.data_ptr() if zm is not None else None, out.data_ptr(), ny, nz,
        cin, wt.shape[2], b_in, cout, b_out, SLIDING_ROWS_PER_STRIP,
        _build.stream_ptr(table.device))
    global SLIDING_LAUNCHES
    SLIDING_LAUNCHES += 1
    _build.check(rc, "dz_rowpad_conv_sliding")
    return out


def rowpad_conv_plain(table, nbr, weight, zmask=None, *, nz, cin, cout,
                      z_stride=1, out_nz=None, mode="subm"):
    """K4's plain version: the gathered taps z-convolved as one matmul, in
    f32 from the values given (the weight is not rounded), returned as f32
    (ny_out, out_nz*cout, b_out); zero where `zmask` marks a site empty.
    `nz` is the input nz; in 'up' mode the forward input nz, with the
    forward output level's (ny, nz//2*cin, B) table."""
    _check_train_args("rowpad_conv", table, nbr, nz, cin, mode, z_stride)
    ny_out, _, b_out = nbr.shape
    onz = _out_nz(nz, z_stride, out_nz)
    g = _gather_taps(table, nbr, nz=nz, cin=cin, mode=mode)
    w3 = weight.float().reshape(3, 9 * cin, cout)
    acc = zconv_matmul(g, w3, 1 if mode == "up" else z_stride, onz)
    if zmask is not None:
        zm = zmask[:, :onz].permute(0, 2, 1).reshape(-1, onz, 1)
        acc = torch.where(zm, acc, 0.0)
    return acc.reshape(ny_out, b_out, onz * cout).permute(0, 2, 1) \
        .contiguous()


def rowpad_conv(table, nbr, weight, zmask=None, *, nz, cin, cout,
                z_stride=1, out_nz=None, mode="subm"):
    """Kernel K4 on CUDA tensors, its plain version on CPU tensors (f32
    out).  Contract of `rowpad_conv_plain`.  The kernel reads the table and
    the weight in the table's dtype, float32 or else bf16 (float32 only for
    the card-vs-CPU gradient check; see the module docstring), sums in f32
    and returns that dtype; it takes cout in multiples of 16 and, in bf16,
    output rows of at most 65536 sites (out_nz * B_out)."""
    if table.device.type == "cpu":
        return rowpad_conv_plain(table, nbr, weight, zmask, nz=nz, cin=cin,
                                 cout=cout, z_stride=z_stride, out_nz=out_nz,
                                 mode=mode)
    _check_train_args("rowpad_conv", table, nbr, nz, cin, mode, z_stride)
    ny_in, _, b_in = table.shape
    ny_out, _, b_out = nbr.shape
    onz = _out_nz(nz, z_stride, out_nz)
    if weight.shape != (27, cin, cout):
        raise ValueError(f"rowpad_conv: weight {tuple(weight.shape)} for "
                         f"cin={cin}, cout={cout}")
    dt = torch.float32 if table.dtype == torch.float32 else torch.bfloat16
    table = table.to(dt).contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    w = weight.to(dt).contiguous()
    tensors = [table, nbr, w]
    zm = None
    if zmask is not None:
        zm = zmask[:, :onz].to(torch.uint8).contiguous()
        if zm.shape != (ny_out, onz, b_out):
            raise ValueError(f"rowpad_conv: zmask {tuple(zmask.shape)}")
        tensors.append(zm)
    _build.require_cuda("rowpad_conv", *tensors)
    if cout % 16:
        raise ValueError(f"rowpad_conv: the kernel takes cout in multiples "
                         f"of 16, got {cout}")
    out = torch.empty((ny_out, onz * cout, b_out), dtype=dt,
                      device=table.device)
    rc = _build.lib().dz_rowpad_conv(
        table.data_ptr(), nbr.data_ptr(), w.data_ptr(),
        zm.data_ptr() if zm is not None else None, out.data_ptr(), ny_in,
        nz, cin, b_in, ny_out, onz, cout, b_out, _MODES[mode],
        1 if mode == "up" else z_stride, int(dt == torch.float32),
        _build.stream_ptr(table.device))
    global CONV_LAUNCHES
    CONV_LAUNCHES += 1
    _build.check(rc, "dz_rowpad_conv")
    return out


def rowpad_conv_dw_plain(table, nbr, d_out, zmask=None, *, nz, cin, cout,
                         z_stride=1, out_nz=None, mode="subm"):
    """K5's plain version: dW[k, ci, co] = sum over output sites of
    x_k[ci] * d_out[co], in f32 from bf16-rounded inputs, skipping the sites
    `zmask` marks empty.  Returns (27, cin, cout) f32 (spconv order, the
    reference's `dw_to_spconv` layout).  Modes 'subm' and 'down'."""
    if mode not in ("subm", "down"):
        raise ValueError(f"rowpad_conv_dw: mode {mode!r}")
    _check_train_args("rowpad_conv_dw", table, nbr, nz, cin, mode, z_stride)
    ny_out, _, b_out = nbr.shape
    onz = _out_nz(nz, z_stride, out_nz)
    g = _gather_taps(table.to(torch.bfloat16), nbr, nz=nz, cin=cin,
                     mode=mode)
    d = d_out.to(torch.bfloat16).float().reshape(ny_out, onz, cout, b_out)
    d = d.permute(0, 3, 1, 2).reshape(-1, onz, cout)
    if zmask is not None:
        zm = zmask[:, :onz].permute(0, 2, 1).reshape(-1, onz, 1)
        d = torch.where(zm, d, 0.0)
    gp = F.pad(g, (0, 0, 1, 1))
    span = z_stride * (onz - 1) + 1
    dw3 = [torch.einsum("nzk,nzc->kc", gp[:, t:t + span:z_stride], d)
           for t in range(3)]
    return torch.stack(dw3).reshape(27, cin, cout)


def rowpad_conv_dw(table, nbr, d_out, zmask=None, *, nz, cin, cout,
                   z_stride=1, out_nz=None, mode="subm"):
    """Kernel K5 on CUDA tensors, its plain version on CPU tensors; both
    return (27, cin, cout) f32."""
    if table.device.type == "cpu":
        return rowpad_conv_dw_plain(table, nbr, d_out, zmask, nz=nz,
                                    cin=cin, cout=cout, z_stride=z_stride,
                                    out_nz=out_nz, mode=mode)
    if mode not in ("subm", "down"):
        raise ValueError(f"rowpad_conv_dw: mode {mode!r}")
    _check_train_args("rowpad_conv_dw", table, nbr, nz, cin, mode, z_stride)
    ny_in, _, b_in = table.shape
    ny_out, _, b_out = nbr.shape
    onz = _out_nz(nz, z_stride, out_nz)
    bf = torch.bfloat16
    table = table.to(bf).contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    d_out = d_out.to(bf).contiguous()
    if d_out.shape != (ny_out, onz * cout, b_out):
        raise ValueError(f"rowpad_conv_dw: d_out {tuple(d_out.shape)}")
    tensors = [table, nbr, d_out]
    zm = None
    if zmask is not None:
        zm = zmask[:, :onz].to(torch.uint8).contiguous()
        if zm.shape != (ny_out, onz, b_out):
            raise ValueError(f"rowpad_conv_dw: zmask {tuple(zmask.shape)}")
        tensors.append(zm)
    _build.require_cuda("rowpad_conv_dw", *tensors)
    if cout % 16:
        raise ValueError(f"rowpad_conv_dw: the kernel takes cout in "
                         f"multiples of 16, got {cout}")
    n_chunks = -(-ny_out // DW_ROWS_PER_CHUNK)
    partial = torch.empty((n_chunks, 27, cin, cout), dtype=torch.float32,
                          device=table.device)
    out = torch.empty((27, cin, cout), dtype=torch.float32,
                      device=table.device)
    rc = _build.lib().dz_rowpad_conv_dw(
        table.data_ptr(), nbr.data_ptr(), d_out.data_ptr(),
        zm.data_ptr() if zm is not None else None, partial.data_ptr(),
        out.data_ptr(), ny_in, nz, cin, b_in, ny_out, onz, cout, b_out,
        int(mode == "down"), z_stride, DW_ROWS_PER_CHUNK,
        _build.stream_ptr(table.device))
    global DW_LAUNCHES
    DW_LAUNCHES += 1
    _build.check(rc, "dz_rowpad_conv_dw")
    return out


def flip_weight(weight, cin, cout):
    """The input-gradient conv's weight: taps t and j reversed, ci and co
    swapped, (27, cin, cout) -> (27, cout, cin) (`pallas_pillar.py:821`)."""
    return weight.reshape(3, 9, cin, cout).flip(0, 1).transpose(2, 3) \
        .reshape(27, cout, cin)


class RowpadConv(torch.autograd.Function):
    """conv(table, weight) with the reference's scatter-free VJP
    (`pallas_pillar.make_conv_op`):

        out     = K4(table, nbr, W), or K9 under USE_SLIDING ('subm', z
                  stride 1), as make_conv_op chooses at trace time
        d_table = K4(ct, nbr | nbr_up, flip_weight(W))  ('subm' | 'up')
        dW      = K5(table, nbr, ct)

    The cotangent is rounded to bf16 first, as the reference does.
    `zmask_out` (the output level's site mask) zeroes the forward output at
    empty sites and lets K5 skip them; `zmask_in` (the input level's) does
    the same for d_table.  Either may be None.  No gradient for the maps;
    d_table only when the table needs one."""

    @staticmethod
    def forward(ctx, table, weight, nbr, nbr_up, zmask_out, zmask_in, nz,
                cin, cout, z_stride, out_nz, mode):
        onz = _out_nz(nz, z_stride, out_nz)
        if USE_SLIDING and mode == "subm" and z_stride == 1:
            out = rowpad_conv_sliding(table, nbr, weight, zmask_out, nz=nz,
                                      cin=cin, cout=cout)
        else:
            out = rowpad_conv(table, nbr, weight, zmask_out, nz=nz, cin=cin,
                              cout=cout, z_stride=z_stride, out_nz=onz,
                              mode=mode)
        ctx.save_for_backward(table, weight, nbr, nbr_up, zmask_out,
                              zmask_in)
        ctx.meta = (nz, cin, cout, z_stride, onz, mode)
        return out.to(table.dtype)

    @staticmethod
    def backward(ctx, ct):
        table, weight, nbr, nbr_up, zmask_out, zmask_in = ctx.saved_tensors
        nz, cin, cout, z_stride, onz, mode = ctx.meta
        ct = ct.to(torch.bfloat16)
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            # in the table's dtype: a float32 model convolves the rounded
            # cotangent with the float32 weight, as the reference does
            d_table = rowpad_conv(
                ct.to(table.dtype), nbr if mode == "subm" else nbr_up,
                flip_weight(weight, cin, cout), zmask_in, nz=nz, cin=cout,
                cout=cin, out_nz=nz, mode="subm" if mode == "subm" else "up",
            ).to(table.dtype)
        if ctx.needs_input_grad[1]:
            d_w = rowpad_conv_dw(table, nbr, ct, zmask_out, nz=nz, cin=cin,
                                 cout=cout, z_stride=z_stride, out_nz=onz,
                                 mode=mode).to(weight.dtype)
        return (d_table, d_w) + (None,) * 10

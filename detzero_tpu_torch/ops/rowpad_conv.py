"""Fused row-padded sparse conv (kernel K2), eval mode:
out = relu(conv(table) * scale + bias [+ residual]) * zmask.

Replaces `detzero_tpu/ops/pallas_pillar.py::rowpad_conv_fused`.  The CUDA
kernel is `csrc/rowpad_conv.cu`.  On the flagship scene about one voxel in
fifty is occupied, so what bounds it on the H100 is writing the output
table, not the arithmetic; the kernel computes only the sites zmask marks
occupied and gathers their taps by rank from device memory.  See the source.

Tensor contract (the reference's, with the spconv-order weight):
  table    (ny_in, nz*cin, B_in)
  nbr      (ny_out, 16, B_out) int32; rows 0..8 = rank of tap j's neighbour
           inside its source row (y+dy for 'subm', 2y+dy for 'down'),
           >= B_in when absent
  weight   (27, cin, cout), k = ((dz+1)*3 + (dy+1))*3 + (dx+1)
  scale, bias (cout,) f32 folded BN affine
  zmask    (ny_out, out_nz, B_out) bool
  residual (ny_out, out_nz*cout, B_out) or None
Returns (ny_out, out_nz*cout, B_out).

`rowpad_conv_fused` launches the kernel for CUDA tensors (computed in bf16
with f32 accumulation, bf16 out, as the TPU kernel does) and takes the plain
PyTorch version for CPU tensors (computed in f32, returned in the table's
dtype).  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from detzero_tpu_torch import _build
from detzero_tpu_torch.ops.pillars import NBR_ROWS, zconv_matmul

LAUNCHES = 0


def _out_nz(nz, z_stride, out_nz):
    return out_nz if out_nz is not None else (nz - 1) // z_stride + 1


def rowpad_conv_fused_plain(table, nbr, weight, scale, bias, zmask,
                            residual=None, *, nz, cin, cout, z_stride=1,
                            out_nz=None, mode="subm", relu=True):
    """Gather the 9 BEV taps by rank, z-conv them as one matmul, apply the
    epilogue.  Computes in f32 from the inputs' values (the weight is first
    rounded to the table's dtype, as the kernel sees it)."""
    if mode not in ("subm", "down"):
        raise ValueError(f"rowpad_conv_fused: mode {mode!r}")
    ny_in, w_in, b_in = table.shape
    ny_out, _, b_out = nbr.shape
    onz = _out_nz(nz, z_stride, out_nz)
    flat = table.permute(0, 2, 1).reshape(ny_in * b_in, w_in).float()
    out_row = torch.arange(ny_out * b_out, device=table.device) // b_out
    nbr_flat = nbr.permute(0, 2, 1).reshape(ny_out * b_out, -1).long()
    parts = []
    for j in range(9):
        dy = j // 3 - 1
        src = out_row + dy if mode == "subm" else 2 * out_row + dy
        src = torch.clamp(src, 0, ny_in - 1)
        rank = nbr_flat[:, j]
        fnd = (rank >= 0) & (rank < b_in)
        g = flat[torch.where(fnd, src * b_in + rank, 0)].reshape(-1, nz, cin)
        parts.append(torch.where(fnd[:, None, None], g, 0.0))
    g = torch.cat(parts, -1)
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

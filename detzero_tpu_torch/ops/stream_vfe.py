"""Stream VFE (kernel K1): the sorted point stream -> per-voxel means in the
row-padded transposed conv layout (ny, nz*F, B).

Replaces `detzero_tpu/ops/pallas_pillar.py::stream_rowpad_feats`.  The CUDA
kernel is `csrc/stream_vfe.cu`: one block per BEV row builds the row's
(nz*F, B) tile in shared memory (the head thread of each voxel's run sums
the run in stream order, so no atomics are needed) and writes it to device
memory once, 16 bytes a store.  What bounds it on the H100 is bytes (one
read of the stream, one write of the table); see the source for the design.

`stream_rowpad_feats` launches the kernel for CUDA tensors and takes the
plain PyTorch version for CPU tensors.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from detzero_tpu_torch import _build
from detzero_tpu_torch.ops.pillars import segment_sum_sorted

LAUNCHES = 0


def stream_rowpad_feats_plain(payload, lane, z, wstart, *, nz, ny,
                              row_budget, out_dtype=torch.float32):
    """payload (P, F+1) features plus the in-budget weight; lane, z (P,);
    wstart (ny+1,) per-row windows into the stream.  Returns the per-voxel
    means sum / max(count, 1) as (ny, nz*F, B); a lane >= B selects
    nothing."""
    b = row_budget
    f = payload.shape[1] - 1
    t = torch.arange(payload.shape[0], device=payload.device)
    row = torch.searchsorted(wstart.long(), t, right=True) - 1
    ok = (t < wstart[ny]) & (lane >= 0) & (lane < b) & (z >= 0) & (z < nz)
    seg = ((row * b + lane) * nz + z)[ok]      # nondecreasing: stream order
    sums = segment_sum_sorted(payload[ok], seg, ny * b * nz)
    feats = sums[:, :f] / torch.clamp(sums[:, f:], min=1.0)
    feats = feats.reshape(ny, b, nz, f).permute(0, 2, 3, 1)
    return feats.reshape(ny, nz * f, b).to(out_dtype)


def stream_rowpad_feats(payload, lane, z, wstart, *, nz, ny, row_budget,
                        out_dtype=torch.float32):
    """Kernel K1 on CUDA tensors, its plain version on CPU tensors."""
    if payload.device.type == "cpu":
        return stream_rowpad_feats_plain(payload, lane, z, wstart, nz=nz,
                                         ny=ny, row_budget=row_budget,
                                         out_dtype=out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stream_rowpad_feats: out_dtype {out_dtype}")
    payload = payload.float().contiguous()
    lane = lane.to(torch.int32).contiguous()
    z = z.to(torch.int32).contiguous()
    wstart = wstart.to(torch.int32).contiguous()
    _build.require_cuda("stream_rowpad_feats", payload, lane, z, wstart)
    if wstart.shape != (ny + 1,) or lane.shape != (payload.shape[0],) \
            or z.shape != lane.shape:
        raise ValueError(f"stream_rowpad_feats: payload "
                         f"{tuple(payload.shape)}, lane {tuple(lane.shape)}, "
                         f"z {tuple(z.shape)}, wstart {tuple(wstart.shape)} "
                         f"for ny={ny}")
    f = payload.shape[1] - 1
    out = torch.empty((ny, nz * f, row_budget), dtype=out_dtype,
                      device=payload.device)
    rc = _build.lib().dz_stream_vfe(
        payload.data_ptr(), lane.data_ptr(), z.data_ptr(), wstart.data_ptr(),
        out.data_ptr(), ny, nz, f, row_budget,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(payload.device))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(rc, "dz_stream_vfe")
    return out

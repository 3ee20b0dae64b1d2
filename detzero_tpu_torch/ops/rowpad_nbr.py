"""Kernel K8: the neighbour-rank maps of the row-pad plan (`rowpad_nbr`,
replaces `detzero_tpu/ops/pallas_pillar.py::rowpad_nbr`, `csrc/rowpad_nbr.cu`).

Each sample's plan builds 10 maps (`backbone3d_pallas.augment_plan_rowpad`):
'subm' at every level, 'down' and 'up' between neighbouring levels.  The
plain version is `pillars.rowpad_nbr_rank`, which materialises a
(ny_out, B_in, B_out) compare per tap, some ten torch launches a tap; the
kernel builds a map in one launch, one block per output row.

`rowpad_nbr` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors; on any other device it raises.  `LAUNCHES` counts
kernel launches.
"""

from __future__ import annotations

import torch

from detzero_tpu_torch import _build
from detzero_tpu_torch.ops.pillars import NBR_ROWS, rowpad_nbr_rank

LAUNCHES = 0
_MODES = {"subm": 0, "down": 1, "up": 2}


def rowpad_nbr(xq_rp, x_in, mode="subm"):
    """(ny_out, NBR_ROWS, B_out) int32 neighbour ranks from per-row sorted
    x-coords, the contract of `pallas_pillar.rowpad_nbr`: xq_rp (ny_out,
    B_out) the output slots' x-coords, x_in (ny_in, B_in) the target level's
    ('up': the strided conv's output level), NBR_BIG in empty slots; rows
    0..8 the rank of tap j's neighbour in its target row, B_in where absent,
    rows 9..15 B_in."""
    if xq_rp.device.type == "cpu":
        return rowpad_nbr_rank(xq_rp, x_in, mode)
    if mode not in _MODES:
        raise ValueError(f"rowpad_nbr: mode {mode!r}")
    if xq_rp.dim() != 2 or x_in.dim() != 2 or x_in.shape[0] == 0:
        raise ValueError(f"rowpad_nbr: xq {tuple(xq_rp.shape)}, x_in "
                         f"{tuple(x_in.shape)}")
    xq = xq_rp.to(torch.int32).contiguous()
    xt = x_in.to(torch.int32).contiguous()
    _build.require_cuda("rowpad_nbr", xq, xt)
    (ny_out, b_out), (ny_in, b_in) = xq.shape, xt.shape
    out = torch.empty((ny_out, NBR_ROWS, b_out), dtype=torch.int32,
                      device=xq.device)
    rc = _build.lib().dz_rowpad_nbr(
        xq.data_ptr(), xt.data_ptr(), out.data_ptr(), ny_out, b_out, ny_in,
        b_in, _MODES[mode], _build.stream_ptr(xq.device))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(rc, "dz_rowpad_nbr")
    return out

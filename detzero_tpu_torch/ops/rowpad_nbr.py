"""Kernel K8: the neighbour-rank maps of the row-pad plan (`rowpad_nbr_maps`,
`rowpad_nbr`; replaces `detzero_tpu/ops/pallas_pillar.py::rowpad_nbr`,
`csrc/rowpad_nbr.cu`).

Each sample's plan builds 10 maps (`backbone3d_pallas.augment_plan_rowpad`):
'subm' at every level, 'down' and 'up' between neighbouring levels.  The
plain version is `pillars.rowpad_nbr_rank`, which materialises a
(ny_out, B_in, B_out) compare per tap, some ten torch launches a tap; the
kernel builds all the maps of one call in one launch, one block per output
row, a binary search per tap.

The wrappers launch the kernel for CUDA tensors and take the plain version,
map by map, for CPU tensors; on any other device they raise.  `LAUNCHES`
counts kernel launches: one a `rowpad_nbr_maps` call.
"""

from __future__ import annotations

import ctypes

import torch

from detzero_tpu_torch import _build
from detzero_tpu_torch.ops.pillars import NBR_ROWS, rowpad_nbr_rank

LAUNCHES = 0
_MODES = {"subm": 0, "down": 1, "up": 2}
# the kernel takes the descriptors of at most this many maps by value
MAX_MAPS = 16


def rowpad_nbr_maps(cases):
    """[(xq_rp, x_in, mode), ...] -> the (ny_out, NBR_ROWS, B_out) int32
    neighbour maps of `rowpad_nbr`, one a case, in one kernel launch on the
    card (the maps are views of one buffer)."""
    if not cases:
        return []
    if cases[0][0].device.type == "cpu":
        return [rowpad_nbr_rank(xq, x_in, mode) for xq, x_in, mode in cases]
    if len(cases) > MAX_MAPS:
        raise ValueError(f"rowpad_nbr_maps: {len(cases)} maps, at most "
                         f"{MAX_MAPS} a launch")
    args = []
    for xq, x_in, mode in cases:
        if mode not in _MODES:
            raise ValueError(f"rowpad_nbr: mode {mode!r}")
        if xq.dim() != 2 or x_in.dim() != 2 or x_in.shape[0] == 0:
            raise ValueError(f"rowpad_nbr: xq {tuple(xq.shape)}, x_in "
                             f"{tuple(x_in.shape)}")
        args.append((xq.to(torch.int32).contiguous(),
                     x_in.to(torch.int32).contiguous(), _MODES[mode]))
    _build.require_cuda("rowpad_nbr", *(t for a in args for t in a[:2]))
    sizes = [xq.shape[0] * NBR_ROWS * xq.shape[1] for xq, _, _ in args]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=args[0][0].device)
    maps = [v.view(xq.shape[0], NBR_ROWS, xq.shape[1]) for v, (xq, _, _)
            in zip(torch.split(buf, sizes), args)]
    ptrs = (ctypes.c_void_p * (3 * len(args)))(*[
        p for (xq, xt, _), out in zip(args, maps)
        for p in (xq.data_ptr(), xt.data_ptr(), out.data_ptr())])
    dims = (ctypes.c_int * (5 * len(args)))(*[
        d for xq, xt, mode in args
        for d in (*xq.shape, *xt.shape, mode)])
    rc = _build.lib().dz_rowpad_nbr_maps(
        ptrs, dims, len(args), _build.stream_ptr(buf.device))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(rc, "dz_rowpad_nbr_maps")
    return maps


def rowpad_nbr(xq_rp, x_in, mode="subm"):
    """(ny_out, NBR_ROWS, B_out) int32 neighbour ranks from per-row sorted
    x-coords, the contract of `pallas_pillar.rowpad_nbr`: xq_rp (ny_out,
    B_out) the output slots' x-coords, x_in (ny_in, B_in) the target level's
    ('up': the strided conv's output level), NBR_BIG in empty slots; rows
    0..8 the rank of tap j's neighbour in its target row, B_in where absent,
    rows 9..15 B_in.  One map, one launch on the card."""
    return rowpad_nbr_maps([(xq_rp, x_in, mode)])[0]

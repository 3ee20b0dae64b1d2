"""Rotated BEV IoU matrix (kernel K3): (N, 5) x (M, 5) -> (N, M), boxes as
[x, y, dx, dy, heading].

Replaces `detzero_tpu/ops/pallas_iou.py::boxes_iou_bev`.  The CUDA kernel is
`csrc/iou_bev.cu`: one thread per pair, the clipped polygon (at most 8
vertices) in registers.  What bounds it on the H100 is arithmetic, about
1.5k flops per pair; see the source.

Both versions follow `pallas_iou._clip_area` step for step: clip A's quad by
B's four half-planes (Sutherland-Hodgman, on-edge tolerance 1e-3, |denom|
guard 1e-8, order-keeping compaction), shoelace area, union clamped at
1e-6.  `boxes_iou_bev` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from detzero_tpu_torch import _build

LAUNCHES = 0

_CAP = 8
_EPS = 1e-8
_TOL = 1e-3


def _corners(b):
    """(K, 5) -> 4 ccw corners [(x, y)], each (K,)."""
    c, s = torch.cos(b[:, 4]), torch.sin(b[:, 4])
    hx, hy = b[:, 2] * 0.5, b[:, 3] * 0.5
    out = []
    for tx, ty in ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0)):
        lx, ly = tx * hx, ty * hy
        out.append((b[:, 0] + lx * c - ly * s, b[:, 1] + lx * s + ly * c))
    return out


def _nxt(arr, k, n):
    """Slot k's successor in the compacted ring of n: k+1, n-1 wraps to 0."""
    return torch.where(n == float(k + 1), arr[0], arr[(k + 1) % _CAP])


def _clip_area(ca, cb, shape):
    """Sutherland-Hodgman intersection area; corner entries broadcast to
    `shape`.  Masks are 0/1 floats as in the reference."""
    zero = torch.zeros(shape, dtype=torch.float32, device=ca[0][0].device)
    one = torch.ones_like(zero)
    px = [ca[k][0].expand(shape) if k < 4 else zero for k in range(_CAP)]
    py = [ca[k][1].expand(shape) if k < 4 else zero for k in range(_CAP)]
    pv = [one if k < 4 else zero for k in range(_CAP)]
    n = torch.full(shape, 4.0, device=zero.device)
    for e in range(4):
        x1, y1 = cb[e]
        x2, y2 = cb[(e + 1) % 4]
        ex, ey = (x2 - x1).expand(shape), (y2 - y1).expand(shape)
        d = [ex * (py[k] - y1) - ey * (px[k] - x1) for k in range(_CAP)]
        inside = [torch.where(d[k] >= -_TOL, pv[k], zero)
                  for k in range(_CAP)]
        ex_px, ex_py, ex_v = [], [], []
        for k in range(_CAP):
            nin = _nxt(inside, k, n) * pv[k]
            crossing = pv[k] * torch.abs(inside[k] - nin)
            denom = d[k] - _nxt(d, k, n)
            t = d[k] / torch.where(torch.abs(denom) > _EPS, denom, one)
            ex_px += [px[k], px[k] + t * (_nxt(px, k, n) - px[k])]
            ex_py += [py[k], py[k] + t * (_nxt(py, k, n) - py[k])]
            ex_v += [inside[k], crossing]
        # compact the valid emits to the front, keeping their order
        rank, run = [], zero
        for v in ex_v:
            rank.append(run)
            run = run + v
        px2, py2, pv2 = [], [], []
        for j in range(_CAP):
            ox, oy, ov = zero, zero, zero
            for i in range(j, 2 * _CAP):
                sel = (ex_v[i] > 0) & (rank[i] == float(j))
                ox = torch.where(sel, ex_px[i], ox)
                oy = torch.where(sel, ex_py[i], oy)
                ov = torch.where(sel, one, ov)
            px2.append(ox)
            py2.append(oy)
            pv2.append(ov)
        px, py, pv, n = px2, py2, pv2, run
    area2 = zero
    for k in range(_CAP):
        area2 = area2 + pv[k] * (px[k] * _nxt(py, k, n)
                                 - _nxt(px, k, n) * py[k])
    return torch.where(n >= 3.0, torch.abs(area2) * 0.5, zero)


def boxes_iou_bev_plain(boxes_a, boxes_b):
    a = boxes_a[:, :5].float()
    b = boxes_b[:, :5].float()
    ca = [(x[:, None], y[:, None]) for x, y in _corners(a)]
    cb = [(x[None, :], y[None, :]) for x, y in _corners(b)]
    inter = _clip_area(ca, cb, (a.shape[0], b.shape[0]))
    area_a = (a[:, 2] * a[:, 3])[:, None]
    area_b = (b[:, 2] * b[:, 3])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def boxes_iou_bev(boxes_a, boxes_b):
    """Kernel K3 on CUDA tensors, its plain version on CPU tensors."""
    if boxes_a.device.type == "cpu":
        return boxes_iou_bev_plain(boxes_a, boxes_b)
    a = boxes_a[:, :5].float().contiguous()
    b = boxes_b[:, :5].float().contiguous()
    _build.require_cuda("boxes_iou_bev", a, b)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    rc = _build.lib().dz_iou_bev(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 a.shape[0], b.shape[0],
                                 _build.stream_ptr(a.device))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(rc, "dz_iou_bev")
    return out

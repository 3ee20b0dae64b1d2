"""Rotated BEV IoU, boxes as [x, y, dx, dy, heading]:

  * kernel K3, the IoU matrix (N, 5) x (M, 5) -> (N, M) (`boxes_iou_bev`,
    replaces `detzero_tpu/ops/pallas_iou.py::boxes_iou_bev`);
  * kernel K7, the intersection areas (N, 5) x (M, 5) -> (N, M)
    (`boxes_overlap_bev`, replaces `pallas_iou.boxes_overlap_bev`, the
    overlap epilogue of the same `_launch`): K3's kernel with the other
    epilogue;
  * kernel K6, matched pairs (N, 5) x (N, 5) -> (N,): intersection areas
    (`boxes_overlap_bev_pairwise`) or IoU (`boxes_iou_bev_pairwise`),
    replacing `pallas_iou._launch_pairwise`.

The CUDA kernels are in `csrc/iou_bev.cu`: the matrix (K3, K7) is two
kernels, one computing each box's corners, areas and edges once, the other
taking a 64 x 64 tile of pairs a block and clipping only the pairs whose
result its cull (`clip_class_plain` here, the same side tests) cannot
tell; the pairwise kernel (K6) clips one pair a thread.  Both keep the clipped polygon (at most 8 vertices) in registers;
the source counts their operations.

All versions follow `pallas_iou._clip_area` step for step: clip A's quad by
B's four half-planes (Sutherland-Hodgman, on-edge tolerance 1e-3, |denom|
guard 1e-8, order-keeping compaction), shoelace area, union clamped at
1e-6.  The wrappers launch the kernels for CUDA tensors and take the plain
versions for CPU tensors.  `LAUNCHES` counts K3's launches (a call's
two kernels count one), `OVERLAP_LAUNCHES` K7's, `PAIRWISE_LAUNCHES` K6's.
"""

from __future__ import annotations

import torch

from detzero_tpu_torch import _build

LAUNCHES = 0
OVERLAP_LAUNCHES = 0
PAIRWISE_LAUNCHES = 0

_CAP = 8
_EPS = 1e-8
_TOL = 1e-3
# floats of a box's record in the matrix kernel's scratch (kRecRows)
_REC_ROWS = 18


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


def _clip_area(ca, cb, shape, live=None):
    """Sutherland-Hodgman intersection area; corner entries broadcast to
    `shape`.  Masks are 0/1 floats as in the reference.  `live`, when a
    list, gets per edge of B the pairs' vertex counts (in, kept inside,
    out), each of `shape`: the work these boxes need."""
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
        if live is not None:
            live.append((n, sum(inside), run))
        px, py, pv, n = px2, py2, pv2, run
    area2 = zero
    for k in range(_CAP):
        area2 = area2 + pv[k] * (px[k] * _nxt(py, k, n)
                                 - _nxt(px, k, n) * py[k])
    return torch.where(n >= 3.0, torch.abs(area2) * 0.5, zero)


# what the clip of a pair comes to, as the matrix kernel's cull tells it
CLIP_EMPTY, CLIP_INSIDE, CLIP_NEEDED = 0, 1, 2


def _clip_class(ca, cb, shape):
    """The cull of `csrc/iou_bev.cu` (classify) on corner lists that
    broadcast to `shape`: `_clip_area`'s own side tests of A's four corners
    against B's edges, in its edge order.  The first edge that does not
    keep every corner decides: none kept -> the clip empties the polygon
    (CLIP_EMPTY, area exactly 0); some kept -> CLIP_NEEDED.  Every edge
    keeping every corner leaves A's quad as it was (CLIP_INSIDE, area its
    shoelace).  Returns (class int8, edges tested int8), each of `shape`."""
    cls = torch.full(shape, CLIP_INSIDE, dtype=torch.int8,
                     device=ca[0][0].device)
    tested = torch.full_like(cls, 4)
    open_ = torch.ones(shape, dtype=torch.bool, device=cls.device)
    for e in range(4):
        x1, y1 = cb[e]
        x2, y2 = cb[(e + 1) % 4]
        ex, ey = (x2 - x1).expand(shape), (y2 - y1).expand(shape)
        kept = sum((ex * (y.expand(shape) - y1) - ey * (x.expand(shape) - x1)
                    >= -_TOL).to(torch.int8) for x, y in ca)
        done = open_ & (kept < 4)
        cls = torch.where(done, torch.where(kept == 0, CLIP_EMPTY,
                                            CLIP_NEEDED).to(torch.int8), cls)
        tested = torch.where(done, torch.full_like(tested, e + 1), tested)
        open_ &= ~done
    return cls, tested


def clip_class_plain(boxes_a, boxes_b):
    """(N, 5) x (M, 5) -> (N, M) int8: CLIP_EMPTY where the clip's result is
    exactly 0, CLIP_INSIDE where it is A's own quad area, CLIP_NEEDED
    where only the clip can tell (the matrix kernel's cull)."""
    a = boxes_a[:, :5].float()
    b = boxes_b[:, :5].float()
    ca = [(x[:, None], y[:, None]) for x, y in _corners(a)]
    cb = [(x[None, :], y[None, :]) for x, y in _corners(b)]
    return _clip_class(ca, cb, (a.shape[0], b.shape[0]))[0]


def boxes_overlap_bev_plain(boxes_a, boxes_b):
    """(N, 5) x (M, 5) -> (N, M) intersection areas."""
    a = boxes_a[:, :5].float()
    b = boxes_b[:, :5].float()
    ca = [(x[:, None], y[:, None]) for x, y in _corners(a)]
    cb = [(x[None, :], y[None, :]) for x, y in _corners(b)]
    return _clip_area(ca, cb, (a.shape[0], b.shape[0]))


def boxes_iou_bev_plain(boxes_a, boxes_b):
    inter = boxes_overlap_bev_plain(boxes_a, boxes_b)
    area_a = (boxes_a[:, 2].float() * boxes_a[:, 3].float())[:, None]
    area_b = (boxes_b[:, 2].float() * boxes_b[:, 3].float())[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def _matrix(boxes_a, boxes_b, iou):
    if boxes_a.device.type == "cpu":
        return (boxes_iou_bev_plain if iou
                else boxes_overlap_bev_plain)(boxes_a, boxes_b)
    a = boxes_a[:, :5].float().contiguous()
    b = boxes_b[:, :5].float().contiguous()
    _build.require_cuda("boxes_bev_matrix", a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != 5 or b.shape[1] != 5:
        raise ValueError(f"boxes_bev_matrix: boxes must be (N, 5+), got "
                         f"{tuple(boxes_a.shape)} and {tuple(boxes_b.shape)}")
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    # the kernel's per-box records: corners, areas, edge vectors
    rec = torch.empty(_REC_ROWS * (a.shape[0] + b.shape[0]),
                      dtype=torch.float32, device=a.device)
    rc = _build.lib().dz_iou_bev(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 rec.data_ptr(), a.shape[0], b.shape[0],
                                 int(iou), _build.stream_ptr(a.device))
    global LAUNCHES, OVERLAP_LAUNCHES
    if iou:
        LAUNCHES += 1
    else:
        OVERLAP_LAUNCHES += 1
    _build.check(rc, "dz_iou_bev")
    return out


def boxes_iou_bev(boxes_a, boxes_b):
    """Kernel K3 on CUDA tensors, its plain version on CPU tensors."""
    return _matrix(boxes_a, boxes_b, iou=True)


def boxes_overlap_bev(boxes_a, boxes_b):
    """Kernel K7 on CUDA tensors, its plain version on CPU tensors."""
    return _matrix(boxes_a, boxes_b, iou=False)


def boxes_overlap_bev_pairwise_plain(boxes_a, boxes_b):
    """(N, 5) x (N, 5) -> (N,) intersection areas of the matched pairs."""
    a = boxes_a[:, :5].float()
    b = boxes_b[:, :5].float()
    return _clip_area(_corners(a), _corners(b), (a.shape[0],))


def boxes_iou_bev_pairwise_plain(boxes_a, boxes_b):
    a = boxes_a[:, :5].float()
    b = boxes_b[:, :5].float()
    inter = boxes_overlap_bev_pairwise_plain(a, b)
    return inter / torch.clamp(a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter,
                               min=1e-6)


def _pairwise(boxes_a, boxes_b, iou):
    if boxes_a.device.type == "cpu":
        return (boxes_iou_bev_pairwise_plain if iou
                else boxes_overlap_bev_pairwise_plain)(boxes_a, boxes_b)
    a = boxes_a[:, :5].float().contiguous()
    b = boxes_b[:, :5].float().contiguous()
    _build.require_cuda("boxes_bev_pairwise", a, b)
    if a.shape != b.shape:
        raise ValueError(f"boxes_bev_pairwise: {tuple(a.shape)} and "
                         f"{tuple(b.shape)} are not matched pairs")
    out = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    rc = _build.lib().dz_iou_bev_pairwise(a.data_ptr(), b.data_ptr(),
                                          out.data_ptr(), a.shape[0],
                                          int(iou),
                                          _build.stream_ptr(a.device))
    global PAIRWISE_LAUNCHES
    PAIRWISE_LAUNCHES += 1
    _build.check(rc, "dz_iou_bev_pairwise")
    return out


def boxes_overlap_bev_pairwise(boxes_a, boxes_b):
    """Kernel K6 (overlap) on CUDA tensors, its plain version on CPU."""
    return _pairwise(boxes_a, boxes_b, iou=False)


def boxes_iou_bev_pairwise(boxes_a, boxes_b):
    """Kernel K6 (IoU) on CUDA tensors, its plain version on CPU."""
    return _pairwise(boxes_a, boxes_b, iou=True)

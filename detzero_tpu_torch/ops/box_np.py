"""NumPy box geometry on the host (port of detzero_tpu/ops/box_np.py, the
same functions computing the same bits).

Rotated-box semantics of the reference's iou3d_nms_kernel.cu (box_overlap,
box_union, iou_bev) and iou3d_nms_utils.py (boxes_iou3d_gpu,
boxes_giou3d_gpu).  Boxes are (x, y, z, dx, dy, dz, heading) with heading
about +z.  The data path uses it for range masking, GT-sampling collisions
and points-in-box tests; the plain-loop overlap is kept as the oracle the
vectorised one is held to.
"""

from __future__ import annotations

import numpy as np


def boxes_to_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 5+) [x, y, dx, dy, heading, ...] -> (N, 4, 2) corners (ccw)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    x, y, dx, dy, rz = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3], boxes[:, 4]
    template = np.array(
        [[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]], dtype=np.float64
    )
    corners = template[None, :, :] * np.stack([dx, dy], axis=-1)[:, None, :]
    c, s = np.cos(rz), np.sin(rz)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2)  # (N,2,2)
    corners = np.einsum("nij,nkj->nki", rot, corners)
    corners[..., 0] += x[:, None]
    corners[..., 1] += y[:, None]
    return corners


def boxes3d_to_bev(boxes3d: np.ndarray) -> np.ndarray:
    """(N,7) -> (N,5) [x, y, dx, dy, heading]."""
    b = np.asarray(boxes3d)
    return b[:, [0, 1, 3, 4, 6]]


def _polygon_clip(subject: list, cx: float, cy: float, nx: float, ny: float):
    """Sutherland–Hodgman: clip polygon by half-plane n·(p-c) <= 0."""
    out = []
    n = len(subject)
    for i in range(n):
        p1, p2 = subject[i], subject[(i + 1) % n]
        d1 = nx * (p1[0] - cx) + ny * (p1[1] - cy)
        d2 = nx * (p2[0] - cx) + ny * (p2[1] - cy)
        if d1 <= 0:
            out.append(p1)
            if d2 > 0:
                t = d1 / (d1 - d2)
                out.append((p1[0] + t * (p2[0] - p1[0]), p1[1] + t * (p2[1] - p1[1])))
        elif d2 <= 0:
            t = d1 / (d1 - d2)
            out.append((p1[0] + t * (p2[0] - p1[0]), p1[1] + t * (p2[1] - p1[1])))
    return out


def _polygon_area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    a = 0.0
    for i in range(len(poly)):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % len(poly)]
        a += x1 * y2 - x2 * y1
    return abs(a) / 2.0


def rotated_overlap_bev(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Exact intersection area of two rotated BEV boxes [x,y,dx,dy,heading]."""
    ca = boxes_to_corners_bev(box_a[None])[0]
    poly = [tuple(p) for p in ca]
    cb = boxes_to_corners_bev(box_b[None])[0]
    for i in range(4):
        p1, p2 = cb[i], cb[(i + 1) % 4]
        ex, ey = p2[0] - p1[0], p2[1] - p1[1]
        # ccw polygon: interior is left of each edge; outward normal = (ey, -ex)
        poly = _polygon_clip(poly, p1[0], p1[1], ey, -ex)
        if not poly:
            return 0.0
    return _polygon_area(poly)


def _convex_hull_area(points: np.ndarray) -> float:
    pts = np.unique(np.round(points, 12), axis=0)
    if len(pts) < 3:
        return 0.0
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return _polygon_area(lower[:-1] + upper[:-1])


def rotated_union_hull_bev(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Convex-hull area of the 8 corners (reference box_union)."""
    ca = boxes_to_corners_bev(box_a[None])[0]
    cb = boxes_to_corners_bev(box_b[None])[0]
    return _convex_hull_area(np.concatenate([ca, cb], axis=0))


def boxes_overlap_bev_vec(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N,5)x(M,5) -> (N,M) intersection areas, fully vectorized.

    Same fixed-8-slot Sutherland–Hodgman + rank-compaction formulation as the
    Pallas kernel, in float64 NumPy — the tracker's per-frame affinity path
    (python-loop clipping was ~50 ms/frame; this is ~100x faster)."""
    n, m = len(boxes_a), len(boxes_b)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    cap = 8
    ca = boxes_to_corners_bev(boxes_a)  # (N, 4, 2) float64
    cb = boxes_to_corners_bev(boxes_b)  # (M, 4, 2)
    px = np.zeros((n, m, cap))
    py = np.zeros((n, m, cap))
    pv = np.zeros((n, m, cap), bool)
    px[:, :, :4] = ca[:, None, :, 0]
    py[:, :, :4] = ca[:, None, :, 1]
    pv[:, :, :4] = True
    cnt = np.full((n, m), 4, np.int64)
    slot = np.arange(cap)

    for e in range(4):
        x1 = cb[None, :, e, 0]              # (1, M)
        y1 = cb[None, :, e, 1]
        x2 = cb[None, :, (e + 1) % 4, 0]
        y2 = cb[None, :, (e + 1) % 4, 1]
        ex = (x2 - x1)[..., None]
        ey = (y2 - y1)[..., None]
        d = ex * (py - y1[..., None]) - ey * (px - x1[..., None])
        inside = (d >= -1e-9) & pv
        last = slot[None, None, :] == (cnt[..., None] - 1)
        nxt_px = np.where(last, px[:, :, :1], np.roll(px, -1, axis=2))
        nxt_py = np.where(last, py[:, :, :1], np.roll(py, -1, axis=2))
        nxt_d = np.where(last, d[:, :, :1], np.roll(d, -1, axis=2))
        nxt_in = np.where(last, inside[:, :, :1], np.roll(inside, -1, axis=2)) & pv
        crossing = pv & (inside != nxt_in)
        denom = d - nxt_d
        t = d / np.where(np.abs(denom) > 1e-12, denom, 1.0)
        ix = px + t * (nxt_px - px)
        iy = py + t * (nxt_py - py)
        # emit interleaved (2*cap slots), then compact valid entries to the
        # front with ONE stable argsort (order-preserving)
        em_x = np.stack([px, ix], axis=3).reshape(n, m, 2 * cap)
        em_y = np.stack([py, iy], axis=3).reshape(n, m, 2 * cap)
        em_v = np.stack([inside, crossing], axis=3).reshape(n, m, 2 * cap)
        order = np.argsort(~em_v, axis=2, kind="stable")[:, :, :cap]
        px = np.take_along_axis(em_x, order, axis=2)
        py = np.take_along_axis(em_y, order, axis=2)
        pv = np.take_along_axis(em_v, order, axis=2)
        px[~pv] = 0.0
        py[~pv] = 0.0
        cnt = pv.sum(axis=2)

    last = slot[None, None, :] == (cnt[..., None] - 1)
    nxt_px = np.where(last, px[:, :, :1], np.roll(px, -1, axis=2))
    nxt_py = np.where(last, py[:, :, :1], np.roll(py, -1, axis=2))
    contrib = np.where(pv, px * nxt_py - nxt_px * py, 0.0)
    area = np.abs(contrib.sum(axis=2)) / 2.0
    return np.where(cnt >= 3, area, 0.0)


def boxes_overlap_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N,5)x(M,5) -> (N,M) intersection areas.

    ORACLE path: per-pair Sutherland–Hodgman with dynamic python lists —
    algorithmically independent of the fixed-slot vectorized/Pallas versions
    it validates. Production host code should call boxes_overlap_bev_vec."""
    out = np.zeros((len(boxes_a), len(boxes_b)))
    for i, a in enumerate(boxes_a):
        for j, b in enumerate(boxes_b):
            out[i, j] = rotated_overlap_bev(a, b)
    return out


def boxes_iou_bev_vec(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N,5)x(M,5) rotated BEV IoU, vectorized (production host path)."""
    ov = boxes_overlap_bev_vec(np.asarray(boxes_a, np.float64),
                               np.asarray(boxes_b, np.float64))
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    return ov / np.clip(area_a + area_b - ov, 1e-6, None)


def boxes_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N,5)x(M,5) rotated BEV IoU."""
    ov = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    return ov / np.clip(area_a + area_b - ov, 1e-6, None)


def height_overlap(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    amax = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    amin = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    bmax = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    bmin = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    return np.clip(np.minimum(amax, bmax) - np.maximum(amin, bmin), 0, None)


def boxes_iou3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N,7)x(M,7) 3D IoU (iou3d_nms_utils.py:74-107 semantics).  The
    polygon clip runs only on the pairs whose BEV circumcircles meet (1 mm
    of slack) and whose heights overlap: every other pair's 3D overlap is
    0 exactly, as the clip gives it, so the matrix equals the all-pairs
    oracle's element for element at a fraction of its cost on scenes of
    many boxes."""
    boxes_a, boxes_b = np.asarray(boxes_a), np.asarray(boxes_b)
    bev_a, bev_b = boxes3d_to_bev(boxes_a), boxes3d_to_bev(boxes_b)
    ov_h = height_overlap(boxes_a, boxes_b)
    ra = 0.5 * np.hypot(bev_a[:, 2], bev_a[:, 3])
    rb = 0.5 * np.hypot(bev_b[:, 2], bev_b[:, 3])
    d = np.hypot(bev_a[:, None, 0] - bev_b[None, :, 0],
                 bev_a[:, None, 1] - bev_b[None, :, 1])
    ov_bev = np.zeros((len(boxes_a), len(boxes_b)))
    near = (d <= ra[:, None] + rb[None, :] + 1e-3) & (ov_h > 0)
    for i, j in zip(*np.nonzero(near)):
        ov_bev[i, j] = rotated_overlap_bev(bev_a[i], bev_b[j])
    ov3d = ov_bev * ov_h
    vol_a = np.prod(boxes_a[:, 3:6], axis=1)[:, None]
    vol_b = np.prod(boxes_b[:, 3:6], axis=1)[None, :]
    return ov3d / np.clip(vol_a + vol_b - ov3d, 1e-6, None)


def boxes_giou3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N,7)x(M,7) GIoU3D (iou3d_nms_utils.py:110-151 semantics, including the
    reference's union-height quirk of min(max_a, max_b) - min(min_a, min_b))."""
    boxes_a, boxes_b = np.asarray(boxes_a), np.asarray(boxes_b)
    bev_a, bev_b = boxes3d_to_bev(boxes_a), boxes3d_to_bev(boxes_b)
    ov_bev = boxes_overlap_bev(bev_a, bev_b)
    hull_bev = np.zeros_like(ov_bev)
    for i, a in enumerate(bev_a):
        for j, b in enumerate(bev_b):
            hull_bev[i, j] = rotated_union_hull_bev(a, b)
    ov_h = height_overlap(boxes_a, boxes_b)
    amax = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    amin = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    bmax = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    bmin = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    union_h = np.clip(np.minimum(amax, bmax) - np.minimum(amin, bmin), 0, None)
    ov3d = ov_bev * ov_h
    hull3d = np.clip(hull_bev * union_h, 1e-6, None)
    vol_a = np.prod(boxes_a[:, 3:6], axis=1)[:, None]
    vol_b = np.prod(boxes_b[:, 3:6], axis=1)[None, :]
    union3d = np.clip(vol_a + vol_b - ov3d, 1e-6, None)
    return ov3d / union3d - (hull3d - union3d) / hull3d


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points: np.ndarray, angle) -> np.ndarray:
    """(N, 3+) points rotated by scalar angle about +z."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    out = points.copy()
    out[:, :2] = points[:, :2] @ rot.T
    return out


def points_in_rotated_box(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """(N,3), (7,) -> bool mask. Canonical-transform point-in-box test
    (roiaware_pool3d_kernel.cu semantics; z measured from box center)."""
    shifted = points[:, :3] - box[:3]
    local = rotate_points_along_z(shifted, -box[6])
    return (
        (np.abs(local[:, 0]) <= box[3] / 2 + 1e-6)
        & (np.abs(local[:, 1]) <= box[4] / 2 + 1e-6)
        & (np.abs(local[:, 2]) <= box[5] / 2 + 1e-6)
    )

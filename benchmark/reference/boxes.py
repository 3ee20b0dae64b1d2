"""Boxes in plain PyTorch and NumPy: the rotated BEV overlap, the 3D IoU of
matched pairs, the center head's decode and the greedy rotated NMS.

The overlap of two convex quads is their intersection's area by Green's
theorem: the part of each edge of one box that lies inside the other,
found by clipping the edge's line against the other box's four half-planes,
adds the cross product of its ends over two.  An edge that lies on the
other box's boundary counts for one box only (closed half-planes for the
first box's edges, open ones for the second's), so equal boxes overlap
once.  Float64 throughout.
"""

from __future__ import annotations

import numpy as np
import torch


def corners(b):
    """(..., 5) [x, y, dx, dy, heading] -> (..., 4, 2) counter-clockwise."""
    c, s = torch.cos(b[..., 4]), torch.sin(b[..., 4])
    hx, hy = b[..., 2] * 0.5, b[..., 3] * 0.5
    out = []
    for tx, ty in ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0)):
        lx, ly = tx * hx, ty * hy
        out.append(torch.stack([b[..., 0] + lx * c - ly * s,
                                b[..., 1] + lx * s + ly * c], -1))
    return torch.stack(out, -2)


def _cross(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _edges_inside(pa, pb, strict):
    """Sum over the edges of polygons pa (..., 4, 2) of cross(start, end)
    of the part inside pb (..., 4, 2)."""
    p = pa[..., :, None, :]                       # edge start (.., 4, 1, 2)
    q = torch.roll(pa, -1, -2)[..., :, None, :]
    e0 = pb[..., None, :, :]                      # clip edge (.., 1, 4, 2)
    e = torch.roll(pb, -1, -2)[..., None, :, :] - e0
    a = _cross(e, p - e0)                         # a + t b >= 0 inside
    b = _cross(e, q - p)
    # an edge parallel to a side lies wholly inside or wholly outside it
    out = (b == 0) & ((a <= 0) if strict else (a < 0))
    t = -a / torch.where(b == 0, torch.ones_like(b), b)
    lo = torch.where(b > 0, t, torch.zeros_like(t))
    hi = torch.where(b < 0, t, torch.ones_like(t))
    t0 = lo.amax(-1).clamp(min=0.0)
    t1 = hi.amin(-1).clamp(max=1.0)
    ok = (t1 > t0) & ~out.any(-1)
    p0 = p[..., 0, :] + t0[..., None] * (q - p)[..., 0, :]
    p1 = p[..., 0, :] + t1[..., None] * (q - p)[..., 0, :]
    return torch.where(ok, _cross(p0, p1), torch.zeros_like(t0)).sum(-1)


def overlap_bev(a, b):
    """Intersection areas of BEV boxes a (..., 5) and b (..., 5),
    broadcast."""
    ca, cb = corners(a.double()), corners(b.double())
    ca, cb = torch.broadcast_tensors(ca, cb)
    area = 0.5 * (_edges_inside(ca, cb, False) + _edges_inside(cb, ca, True))
    return area.clamp(min=0.0)


def iou_bev_matrix(a, b):
    """(K, 5) x (M, 5) -> (K, M) rotated BEV IoU."""
    inter = overlap_bev(a[:, None, :], b[None, :, :])
    area_a = (a[:, 2] * a[:, 3]).double()[:, None]
    area_b = (b[:, 2] * b[:, 3]).double()[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def iou3d_pairs(a, b):
    """(N, 7) x (N, 7) -> (N,) 3D IoU of pair i."""
    a, b = a.double(), b.double()
    ov = overlap_bev(a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]])
    lo = torch.maximum(a[:, 2] - a[:, 5] / 2, b[:, 2] - b[:, 5] / 2)
    hi = torch.minimum(a[:, 2] + a[:, 5] / 2, b[:, 2] + b[:, 5] / 2)
    ov = ov * torch.clamp(hi - lo, min=0.0)
    va = a[:, 3] * a[:, 4] * a[:, 5]
    vb = b[:, 3] * b[:, 4] * b[:, 5]
    return ov / torch.clamp(va + vb - ov, min=1e-6)


def decode_at(maps, inds, cfg):
    """Boxes (M, 9) [x, y, z, dx, dy, dz, heading, vx, vy] at flat cell
    indices of one frame's maps {name: (H, W, ch)}."""
    h, w = cfg["bev_hw"]
    stride = cfg["feature_map_stride"]
    vx, vy = cfg["voxel_size"][:2]
    x0, y0 = cfg["pc_range"][:2]
    xs, ys = (inds % w).float(), torch.div(inds, w,
                                           rounding_mode="floor").float()

    def at(name):
        m = maps[name]
        return m.reshape(h * w, -1)[inds]

    center = at("center")
    cx = (xs + center[:, 0]) * stride * vx + x0
    cy = (ys + center[:, 1]) * stride * vy + y0
    dim = torch.exp(torch.clamp(at("dim"), -5.0, 5.0))
    rot = at("rot")
    cols = [cx[:, None], cy[:, None], at("center_z")[:, :1], dim,
            torch.atan2(rot[:, 0], rot[:, 1])[:, None]]
    if "vel" in maps:
        cols.append(at("vel"))
    return torch.cat(cols, -1)


def greedy_nms(iou, valid, thresh):
    """Greedy suppression over score-sorted boxes: keep box i where it is
    valid and no kept box before it overlaps it by more than `thresh`."""
    iou = np.asarray(iou)
    k = iou.shape[0]
    keep = np.zeros(k, bool)
    suppressed = np.zeros(k, bool)
    for i in range(k):
        if valid[i] and not suppressed[i]:
            keep[i] = True
            suppressed[i + 1:] |= iou[i, i + 1:] > thresh
    return keep


def decode(maps_per_head, cfg, quant=None):
    """One frame's head maps [{name: (H, W, ch)}] -> dict(boxes (post, 9),
    scores, labels, mask): the iou-rectified scores' top k a head (ties to
    the lower index), the boxes there, the rotated NMS of all heads'
    candidates above the score threshold (the pre-NMS top by score, ties to
    the lower index), the kept boxes first.  `quant` rounds the decoded
    boxes (the control's precision)."""
    pp = cfg["post_processing"]
    h, w = cfg["bev_hw"]
    all_boxes, all_scores, all_labels = [], [], []
    for maps, cls_ids in zip(maps_per_head, cfg["class_ids_each_head"]):
        hm = torch.sigmoid(maps["hm"]).reshape(h * w, -1)
        if "iou" in maps:
            iou = torch.clamp((maps["iou"].reshape(h * w) + 1.0) * 0.5, 0.0,
                              1.0)
            hm = hm * torch.pow(iou[:, None], 2.0)
        flat = hm.reshape(-1)
        vals, idx = torch.sort(flat, descending=True, stable=True)
        k = min(pp["TOP_K"], flat.shape[0])
        vals, idx = vals[:k], idx[:k]
        n_cls = hm.shape[1]
        boxes = decode_at(maps, torch.div(idx, n_cls, rounding_mode="floor"),
                          cfg)
        if quant is not None:
            boxes = quant(boxes)
        ids = torch.tensor(cls_ids, dtype=torch.int64, device=hm.device)
        all_boxes.append(boxes)
        all_scores.append(vals)
        all_labels.append(ids[idx % n_cls])
    boxes, scores = torch.cat(all_boxes), torch.cat(all_scores)
    labels = torch.cat(all_labels)
    valid = scores > pp["SCORE_THRESH"]
    masked = torch.where(valid, scores, torch.full_like(scores,
                                                        float("-inf")))
    k = min(pp["NMS_PRE_MAXSIZE"], masked.shape[0])
    top, order = torch.sort(masked, descending=True, stable=True)
    top, order = top[:k], order[:k]
    bev = boxes[order][:, [0, 1, 3, 4, 6]]
    keep = greedy_nms(iou_bev_matrix(bev, bev).cpu().numpy(),
                      torch.isfinite(top).cpu().numpy(), pp["NMS_THRESH"])
    kept = order[torch.from_numpy(np.nonzero(keep)[0]).to(order.device)]
    post = pp["NMS_POST_MAXSIZE"]
    kept = kept[:post]
    n = kept.shape[0]
    pad = post - n
    sel = torch.cat([kept, kept.new_zeros(pad)])
    return {"boxes": boxes[sel], "scores": scores[sel],
            "labels": labels[sel],
            "mask": torch.arange(post, device=boxes.device) < n}

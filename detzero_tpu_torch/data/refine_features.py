"""Feature extraction for the refining models, host-side NumPy (port of
detzero_tpu/data/refine_features.py, the same functions computing the same
bits).  The samplers draw from the `rng` they are given, never from the
global np.random.

Re-derives the reference's refining dataset transforms:
  * box-local / init-box coordinate transforms (datasets/data_utils.py:59,72);
  * GRM per-point features xyz + intensity + p2s + score = 11 dims, where p2s
    is the signed distance to each of the box's 6 faces
    (waymo_geometry_dataset.py:94-119);
  * PRM/CRM per-point features xyz + intensity + p2co + score = 32 dims,
    where p2co is the offset to the 8 corners + center (27 values)
    (waymo_position_dataset.py:98-140);
  * fixed-count point sampling and track padding to QUERY_NUM with masks.
"""

from __future__ import annotations

import numpy as np

from detzero_tpu_torch.ops import box_np


def points_to_box_local(points_xyz, box7):
    """Transform points into the box frame (center at origin, heading to +x)."""
    shifted = np.asarray(points_xyz, np.float64)[:, :3] - np.asarray(box7[:3])
    return box_np.rotate_points_along_z(shifted, -box7[6]).astype(np.float32)


def boxes_to_init_coords(boxes7, init_box7):
    """Express track boxes in the init box's frame
    (reference init_coords_transform)."""
    b = np.asarray(boxes7, np.float64).copy()
    b[:, :3] -= init_box7[:3]
    b[:, :3] = box_np.rotate_points_along_z(b[:, :3], -init_box7[6])
    b[:, 6] -= init_box7[6]
    return b.astype(np.float32)


def boxes_from_init_coords(boxes7, init_box7):
    """Inverse of boxes_to_init_coords (reference box_coords_transform)."""
    b = np.asarray(boxes7, np.float64).copy()
    b[:, :3] = box_np.rotate_points_along_z(b[:, :3], init_box7[6])
    b[:, :3] += init_box7[:3]
    b[:, 6] += init_box7[6]
    return b.astype(np.float32)


def p2s_features(local_pts, dims):
    """(N, 3) box-local points, dims (3,) -> (N, 6) signed distances to the
    six faces (+x, -x, +y, -y, +z, -z); positive inside."""
    d = np.asarray(dims, np.float32) / 2
    x, y, z = local_pts[:, 0], local_pts[:, 1], local_pts[:, 2]
    return np.stack([d[0] - x, d[0] + x, d[1] - y, d[1] + y, d[2] - z, d[2] + z],
                    axis=1)


def p2co_features(local_pts, dims):
    """(N, 3), dims (3,) -> (N, 27): offsets to the 8 box corners + center in
    the local frame."""
    d = np.asarray(dims, np.float32) / 2
    corners = np.array([
        [sx * d[0], sy * d[1], sz * d[2]]
        for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)
    ], np.float32)  # (8, 3)
    anchors = np.concatenate([corners, np.zeros((1, 3), np.float32)])  # (9, 3)
    off = local_pts[:, None, :] - anchors[None, :, :]
    return off.reshape(len(local_pts), 27)


def sample_points(points, n, rng):
    """Sample exactly n rows (with replacement when fewer; zeros when empty)
    with `rng`.  Returns (sampled (n, F), any_real flag)."""
    if len(points) == 0:
        return np.zeros((n, points.shape[1] if points.ndim == 2 else 3),
                        np.float32), False
    idx = rng.choice(len(points), n, replace=len(points) < n)
    return np.asarray(points, np.float32)[idx], True


def grm_point_features(frame_pts, box7, score, num_points, rng):
    """One frame's cropped points (+intensity col 3) -> (num_points, 11)
    GRM features in the box-local frame."""
    pts, ok = sample_points(frame_pts, num_points, rng)
    local = points_to_box_local(pts, box7)
    inten = pts[:, 3:4] if pts.shape[1] > 3 else np.zeros((len(pts), 1), np.float32)
    feats = np.concatenate([
        local, inten, p2s_features(local, box7[3:6]),
        np.full((len(pts), 1), score, np.float32),
    ], axis=1)
    if not ok:
        feats[:] = 0
    return feats


def prm_point_features(frame_pts, box_local7, score, num_points, rng):
    """One frame's points (in INIT-box coords) + the frame's box (init
    coords) -> (num_points, 32) PRM/CRM features."""
    pts, ok = sample_points(frame_pts, num_points, rng)
    rel = pts[:, :3] - box_local7[:3]
    rel = box_np.rotate_points_along_z(
        rel.astype(np.float64), -box_local7[6]).astype(np.float32)
    inten = pts[:, 3:4] if pts.shape[1] > 3 else np.zeros((len(pts), 1), np.float32)
    feats = np.concatenate([
        pts[:, :3], inten, p2co_features(rel, box_local7[3:6]),
        np.full((len(pts), 1), score, np.float32),
    ], axis=1)
    if not ok:
        feats[:] = 0
    return feats


def pad_track(arrays, lengths_to: int):
    """Pad a list of per-box arrays (T, ...) to (lengths_to, ...) + mask."""
    t = len(arrays)
    n = min(t, lengths_to)
    first = np.asarray(arrays[0])
    out = np.zeros((lengths_to, *first.shape), first.dtype)
    for i in range(n):
        out[i] = arrays[i]
    mask = np.arange(lengths_to) < n
    return out, mask


def _select_track_frames(t, matched, training, rng, matched_only=True):
    """Reference frame-selection semantics (waymo_geometry_dataset.py:40-60,
    waymo_position_dataset.py:44-60): training restricts an object track to
    its GT-MATCHED frames (KF-coast / FP frames carry no target signal and
    the reference drops them outright) and random-subsamples between
    min(5, T_m) and T_m of them (track-length augmentation); eval keeps
    every frame (outputs must map 1:1 onto the track). CRM passes
    matched_only=False: its IoU labels are honest on every frame
    (waymo_confidence_dataset.py:69 samples range(traj_len))."""
    idx = np.arange(t)
    if not training:
        return idx
    if matched_only and matched is not None:
        m = np.asarray(matched, bool)[:t]
        if m.any():
            idx = idx[m]
    tm = len(idx)
    k = rng.randint(min(5, tm), tm + 1) if tm > 1 else tm
    sel = rng.choice(tm, size=max(k, 1), replace=False)
    return idx[np.sort(sel)]


class GRMSample:
    """Assemble one GRM training/eval sample from a daemon object record
    (waymo_geometry_dataset.py:26-154 semantics); draws from `rng`."""

    def __init__(self, query_num=3, query_points=256, memory_points=4096,
                 training=False, matched_only=True, *, rng):
        self.query_num = query_num
        self.query_points = query_points
        self.memory_points = memory_points
        self.training = training
        self.matched_only = matched_only
        self.rng = rng

    def __call__(self, obj):
        """obj: {'boxes_global' (T,7), 'score' (T,), 'pts' list of (Ni, 4+)}.
        Returns dict(query_pts (Q, Np, 11), query_sizes (Q, 3),
        memory_pts (M, 11), memory_mask (M,))."""
        boxes = np.asarray(obj["boxes_global"], np.float32)
        scores = np.asarray(obj["score"], np.float32)
        pts = obj["pts"]
        keep = _select_track_frames(len(boxes), obj.get("matched"),
                                    self.training, self.rng,
                                    self.matched_only)
        boxes, scores = boxes[keep], scores[keep]
        pts = [pts[i] for i in keep]
        order = np.argsort(-scores)[: self.query_num]
        q_feats, q_sizes = [], []
        for qi in range(self.query_num):
            i = order[min(qi, len(order) - 1)]
            q_feats.append(grm_point_features(
                np.asarray(pts[i]) if len(pts[i]) else np.zeros((0, 4), np.float32),
                boxes[i], scores[i], self.query_points, self.rng))
            q_sizes.append(boxes[i, 3:6])
        # memory: the track-REGISTERED point cloud — each frame's points in
        # its OWN box's local frame before concatenation (reference
        # waymo_geometry_dataset.py:77-78 local_coords_transform(pts, traj):
        # per-frame registration is what makes the aggregated cloud a dense
        # full view of the rigid object; transforming the global concat by
        # one box smears every MOVING object along its trajectory and the
        # memory carries no shape signal: GRM then collapses to the
        # class-mean size)
        mem_rows = []
        for i in range(len(boxes)):
            p = np.asarray(pts[i], np.float32)
            if not len(p):
                continue
            local = points_to_box_local(p, boxes[i])
            inten = (p[:, 3:4] if p.shape[1] > 3
                     else np.zeros((len(p), 1), np.float32))
            mem_rows.append(np.concatenate([
                local, inten, p2s_features(local, boxes[i, 3:6]),
                np.full((len(p), 1), scores[i], np.float32)], axis=1))
        if mem_rows:
            cat = np.concatenate(mem_rows)
            mem_feats, _ = sample_points(cat, self.memory_points, self.rng)
            mem_mask = np.ones(self.memory_points, bool)
        else:
            mem_feats = np.zeros((self.memory_points, 11), np.float32)
            mem_mask = np.zeros(self.memory_points, bool)
        return {
            "query_pts": np.stack(q_feats),
            "query_sizes": np.stack(q_sizes),
            "memory_pts": mem_feats,
            "memory_mask": mem_mask,
        }


class PRMSample:
    """Assemble one PRM sample (waymo_position_dataset.py:31-184
    semantics); draws from `rng`."""

    def __init__(self, query_num=200, query_points=256, memory_points=48,
                 training=True, matched_only=True, *, rng):
        self.query_num = query_num
        self.query_points = query_points
        self.memory_points = memory_points
        self.training = training
        self.matched_only = matched_only
        self.rng = rng

    def __call__(self, obj):
        boxes = np.asarray(obj["boxes_global"], np.float32)
        scores = np.asarray(obj["score"], np.float32)
        pts = obj["pts"]
        keep = _select_track_frames(len(boxes), obj.get("matched"),
                                    self.training, self.rng,
                                    self.matched_only)
        boxes, scores = boxes[keep], scores[keep]
        pts = [pts[i] for i in keep]
        t = len(boxes)
        init_idx = (self.rng.randint(t) if self.training else t // 2)
        init_box = boxes[init_idx]
        local_boxes = boxes_to_init_coords(boxes, init_box)
        q_feats, m_feats = [], []
        for i in range(min(t, self.query_num)):
            p = np.asarray(pts[i], np.float32) if len(pts[i]) else np.zeros((0, 4), np.float32)
            if len(p):
                pl = p.copy()
                pl[:, :3] = points_to_box_local(p, init_box)  # init coords
            else:
                pl = p
            q_feats.append(prm_point_features(pl, local_boxes[i], scores[i],
                                              self.query_points, self.rng))
            m_feats.append(prm_point_features(pl, local_boxes[i], scores[i],
                                              self.memory_points, self.rng))
        qp, mask = pad_track(q_feats, self.query_num)
        mp, _ = pad_track(m_feats, self.query_num)
        qb, _ = pad_track(
            [local_boxes[i][[0, 1, 2, 6]] for i in range(min(t, self.query_num))],
            self.query_num)
        lb, _ = pad_track(list(local_boxes[: self.query_num]), self.query_num)
        # original track rows of each query (training may subsample matched
        # frames) — the dataset gathers gt targets by these indices; padded
        # rows repeat the last real index (masked out by pad_mask)
        fi = np.full(self.query_num, keep[-1] if len(keep) else 0, np.int64)
        fi[: min(t, self.query_num)] = keep[: self.query_num]
        return {
            "query_pts": qp, "query_boxes": qb, "memory_pts": mp,
            "pad_mask": mask, "init_box": init_box, "local_boxes": lb,
            "frame_idx": fi,
        }


def revert_prm_to_world(centers_local, headings_local, init_box):
    """Refined (T,3) centers + (T,) headings in init coords -> world boxes'
    centers/headings (reference revert_to_each_frame:257)."""
    c = box_np.rotate_points_along_z(
        np.asarray(centers_local, np.float64), init_box[6])
    c += init_box[:3]
    h = np.asarray(headings_local) + init_box[6]
    return c.astype(np.float32), h.astype(np.float32)

"""GRM / PRM test-time augmentation (port of
detzero_tpu/models/refining/tta.py, in float32 NumPy): the variant
fan-out, a static stack over the variant list that one batched forward
evaluates, and the fuse that inverts each variant on the decoded outputs
and averages them (a circular mean for headings).

  * GRM's p2s point-to-surface channels are swapped or recomputed under
    flips and rotations (the half-extents recovered from opposing surface
    distances);
  * PRM's p2co corner-offset channels are permuted and sign-flipped by the
    corner symmetry of the anchor layout.

Variant syntax: "original", "flip_x", "flip_y", "flip_xy",
"scale_<f>", "rot_<angle>".
"""

from __future__ import annotations

import math

import numpy as np

# the reference's default lists (geometry_augment.py:107-121 scales and
# rotations, position_augment.py:113-128)
GRM_DEFAULT_VARIANTS = (
    "original", "flip_x", "flip_y", "flip_xy",
    "scale_0.9", "scale_0.95", "scale_1.05", "scale_1.1",
    "rot_-0.78539816", "rot_0.78539816",
)
PRM_DEFAULT_VARIANTS = (
    "original", "flip_x", "flip_y", "flip_xy",
    "scale_0.85", "scale_0.9", "scale_0.95", "scale_1.05", "scale_1.1",
    "scale_1.15",
    "rot_-0.39365818", "rot_-0.78539816", "rot_-1.17809724",
    "rot_-2.74889357",
    "rot_0.39365818", "rot_0.78539816", "rot_1.17809724", "rot_2.74889357",
)

# p2co anchor permutation when the box-frame y axis flips: corners are
# ordered sx in (1,-1) x sy in (1,-1) x sz in (1,-1) (index = 4*(sx<0) +
# 2*(sy<0) + (sz<0)), center last — flipping sy toggles bit 1.
_P2CO_FLIP_Y_PERM = np.array([2, 3, 0, 1, 6, 7, 4, 5, 8])

_f32 = np.float32


def parse_variant(v: str):
    if v == "original":
        return "orig", 0.0
    if v.startswith("flip_"):
        return v, 0.0
    kind, _, val = v.partition("_")
    return kind, float(val)


def _rot2d(xy, angle):
    c, s = _f32(math.cos(angle)), _f32(math.sin(angle))
    return np.stack([xy[..., 0] * c - xy[..., 1] * s,
                     xy[..., 0] * s + xy[..., 1] * c], axis=-1)


# ----------------------------------------------------------------- GRM ----
# feature layout (data/refine_features.grm_point_features): [x, y, z,
# intensity, p2s(+x, -x, +y, -y, +z, -z), score] = 11 channels.

def _grm_transform_feats(f, variant):
    kind, val = parse_variant(variant)
    f = np.asarray(f, _f32)
    if kind == "orig":
        return f
    if kind.startswith("flip"):
        out = f.copy()
        if "x" in kind[5:]:  # flip about x axis: y := -y, swap +y/-y faces
            out[..., 1] *= -1
            out[..., [6, 7]] = out[..., [7, 6]]
        if "y" in kind[5:]:  # flip about y axis: x := -x, swap +x/-x faces
            out[..., 0] *= -1
            out[..., [4, 5]] = out[..., [5, 4]]
        return out
    if kind == "scale":
        return np.concatenate([f[..., 0:3] * val, f[..., 3:4],
                               f[..., 4:10] * val, f[..., 10:]], axis=-1)
    if kind == "rot":
        xy = _rot2d(f[..., 0:2], val)
        # half-extents recovered from opposing face distances, then p2s
        # recomputed against the rotated coordinates
        dx = (f[..., 4] + f[..., 5]) / 2
        dy = (f[..., 6] + f[..., 7]) / 2
        x, y = xy[..., 0], xy[..., 1]
        p2s = np.stack([dx - x, dx + x, dy - y, dy + y,
                        f[..., 8], f[..., 9]], axis=-1)
        return np.concatenate([xy, f[..., 2:4], p2s, f[..., 10:]], axis=-1)
    raise ValueError(f"unknown TTA variant {variant!r}")


def grm_tta_expand(sample, variants=GRM_DEFAULT_VARIANTS):
    """sample: dict(query_pts (Q, Np, 11), query_sizes (Q, 3), memory_pts
    (M, 11), memory_mask (M,)).  Returns the same keys with a leading
    K = len(variants) axis."""
    sizes = []
    for v in variants:
        kind, val = parse_variant(v)
        sz = np.asarray(sample["query_sizes"], _f32)
        sizes.append(sz * val if kind == "scale" else sz)
    mask = np.asarray(sample["memory_mask"])
    return {
        "query_pts": np.stack([_grm_transform_feats(sample["query_pts"], v)
                               for v in variants]),
        "query_sizes": np.stack(sizes),
        "memory_pts": np.stack([_grm_transform_feats(sample["memory_pts"],
                                                     v) for v in variants]),
        "memory_mask": np.broadcast_to(mask, (len(variants),) + mask.shape)
        .copy(),
    }


def grm_tta_fuse(sizes, variants=GRM_DEFAULT_VARIANTS):
    """sizes (K, 3) decoded per variant -> fused (3,): un-scale, then the
    mean."""
    inv = np.ones(len(variants), _f32)
    for i, v in enumerate(variants):
        kind, val = parse_variant(v)
        if kind == "scale":
            inv[i] = 1.0 / val
    return (np.asarray(sizes, _f32) * inv[:, None]).mean(axis=0)


# ----------------------------------------------------------------- PRM ----
# feature layout (prm_point_features): [x, y, z (init coords), intensity,
# p2co (9 anchors x 3, box-frame offsets), score] = 32 channels.

def _prm_p2co_flip_y(p2co):
    """Box-frame y flip on (..., 27) p2co: permute the sy-paired anchors
    and negate the y component."""
    off = p2co.reshape(p2co.shape[:-1] + (9, 3))[..., _P2CO_FLIP_Y_PERM, :]
    off[..., 1] *= -1
    return off.reshape(p2co.shape)


def _prm_transform_feats(f, variant):
    kind, val = parse_variant(variant)
    f = np.asarray(f, _f32)
    if kind == "orig":
        return f
    out = f.copy()
    if kind == "flip_x":  # world y := -y; box frame sees a y flip
        out[..., 1] *= -1
        out[..., 4:31] = _prm_p2co_flip_y(out[..., 4:31])
        return out
    if kind == "flip_y":  # world x := -x; box frame also sees a y flip
        out[..., 0] *= -1
        out[..., 4:31] = _prm_p2co_flip_y(out[..., 4:31])
        return out
    if kind == "flip_xy":  # box frame unchanged (two y flips cancel)
        out[..., 0] *= -1
        out[..., 1] *= -1
        return out
    if kind == "scale":
        return np.concatenate([f[..., 0:3] * val, f[..., 3:4],
                               f[..., 4:31] * val, f[..., 31:]], axis=-1)
    if kind == "rot":  # rotation about the init origin; box frame unchanged
        return np.concatenate([_rot2d(f[..., 0:2], val), f[..., 2:]],
                              axis=-1)
    raise ValueError(f"unknown TTA variant {variant!r}")


def _prm_transform_boxes(qb, variant):
    """query_boxes (T, 4) [x, y, z, yaw] in init coords."""
    kind, val = parse_variant(variant)
    qb = np.asarray(qb, _f32)
    if kind == "orig":
        return qb
    x, y, z, yaw = qb[..., 0], qb[..., 1], qb[..., 2], qb[..., 3]
    if kind == "flip_x":
        return np.stack([x, -y, z, -yaw], axis=-1)
    if kind == "flip_y":
        return np.stack([-x, y, z, -(yaw + math.pi)], axis=-1)
    if kind == "flip_xy":
        return np.stack([-x, -y, z, yaw - math.pi], axis=-1)
    if kind == "scale":
        return np.concatenate([qb[..., 0:3] * val, qb[..., 3:4]], axis=-1)
    if kind == "rot":
        xy = _rot2d(qb[..., 0:2], val)
        return np.concatenate([xy, z[..., None], (yaw + val)[..., None]],
                              axis=-1)
    raise ValueError(f"unknown TTA variant {variant!r}")


def prm_tta_expand(sample, variants=PRM_DEFAULT_VARIANTS):
    """sample: dict(query_pts (T, Np, 32), query_boxes (T, 4), memory_pts
    (T, Nm, 32), pad_mask (T,)).  Adds a leading K axis."""
    mask = np.asarray(sample["pad_mask"])
    return {
        "query_pts": np.stack([_prm_transform_feats(sample["query_pts"], v)
                               for v in variants]),
        "query_boxes": np.stack([_prm_transform_boxes(sample["query_boxes"],
                                                      v) for v in variants]),
        "memory_pts": np.stack([_prm_transform_feats(sample["memory_pts"],
                                                     v) for v in variants]),
        "pad_mask": np.broadcast_to(mask, (len(variants),) + mask.shape)
        .copy(),
    }


def prm_tta_apply_forward(centers, headings, variant):
    """A variant applied forward to init-coord track poses, centers (T, 3)
    and headings (T,): what a perfect model would predict on the
    transformed input (the targets `prm_tta_fuse` inverts)."""
    kind, val = parse_variant(variant)
    c = np.asarray(centers, _f32).copy()
    h = np.asarray(headings, _f32)
    if kind == "orig":
        return c, h
    if kind == "flip_x":
        c[..., 1] *= -1
        return c, -h
    if kind == "flip_y":
        c[..., 0] *= -1
        return c, -(h + math.pi)
    if kind == "flip_xy":
        c[..., :2] *= -1
        return c, h - math.pi
    if kind == "scale":
        return c * val, h
    if kind == "rot":
        return np.concatenate([_rot2d(c[..., 0:2], val), c[..., 2:]],
                              axis=-1), h + val
    raise ValueError(f"unknown TTA variant {variant!r}")


def prm_tta_fuse(centers, headings, variants=PRM_DEFAULT_VARIANTS):
    """centers (K, T, 3), headings (K, T) decoded per variant -> fused
    ((T, 3), (T,)): each variant inverted, then the centers' mean and the
    headings' circular mean."""
    cs, hs = [], []
    for i, v in enumerate(variants):
        kind, val = parse_variant(v)
        c = np.asarray(centers[i], _f32).copy()
        h = np.asarray(headings[i], _f32)
        if kind == "flip_x":
            c[..., 1] *= -1
            h = -h
        elif kind == "flip_y":
            c[..., 0] *= -1
            h = -h - math.pi
        elif kind == "flip_xy":
            c[..., :2] *= -1
            h = h + math.pi
        elif kind == "scale":
            c = c / val
        elif kind == "rot":
            c = np.concatenate([_rot2d(c[..., 0:2], -val), c[..., 2:]],
                               axis=-1)
            h = h - val
        cs.append(c)
        hs.append(h)
    hs = np.stack(hs)
    return np.stack(cs).mean(axis=0), np.arctan2(np.sin(hs).mean(axis=0),
                                                 np.cos(hs).mean(axis=0))

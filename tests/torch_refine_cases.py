"""Shared inputs of the refining parity tests (numpy only, seeded): tiny
widths (D_MODEL 32, 2 heads, 3 queries of 16 points, 64 memory points,
tracks of 8 boxes padded to 12, 4 memory points a box), the reference's
flax models and their perturbed variables, and daemon-style object
records."""

import numpy as np

D_MODEL, HEADS = 32, 2
Q, NP, M = 3, 16, 64              # GRM queries, points a query, memory
T, T_REAL, NM = 12, 8, 4          # PRM/CRM padded track, real boxes, memory
ANCHORS = np.array([[4.7, 2.1, 1.7], [8.5, 2.8, 3.2], [12.0, 2.9, 3.6]],
                   np.float32)
OPT = {"OPTIMIZER": "adam_onecycle", "LR": 0.001, "WEIGHT_DECAY": 0.01,
       "GRAD_NORM_CLIP": 10.0}
NAMES = {"grm": "GeometryTransformer", "prm": "PositionTransformer",
         "crm": "ConfidencePointNet"}


def grm_batch(seed, b=4):
    """Model inputs and targets of GRM; sample 1 is a track with no points
    (its memory fully masked)."""
    rng = np.random.RandomState(seed)
    mm = rng.rand(b, M) > 0.3
    if b > 1:
        mm[1] = False
    return {"query_pts": rng.randn(b, Q, NP, 11).astype(np.float32),
            "query_sizes": (rng.rand(b, Q, 3) * 4 + 1).astype(np.float32),
            "memory_pts": rng.randn(b, M, 11).astype(np.float32),
            "memory_mask": mm,
            "gt_size": (ANCHORS[rng.randint(3, size=b)]
                        * rng.uniform(0.8, 1.2, (b, 3))).astype(np.float32),
            "has_gt": np.arange(b) != 2}


def track_lengths(b):
    return [T_REAL, T, 3, 1, T_REAL, 5, 2, T][:b]


def prm_batch(seed, b=4):
    """PRM inputs and targets: padded tracks of the lengths above (every
    padded query's self- and cross-attention rows fully masked)."""
    rng = np.random.RandomState(seed)
    pm = np.arange(T)[None] < np.array(track_lengths(b))[:, None]
    return {"query_pts": rng.randn(b, T, NP, 32).astype(np.float32),
            "query_boxes": rng.randn(b, T, 4).astype(np.float32),
            "memory_pts": rng.randn(b, T, NM, 32).astype(np.float32),
            "pad_mask": pm,
            "gt_centers": (rng.randn(b, T, 3) * 0.3).astype(np.float32),
            "gt_headings": rng.uniform(-np.pi, np.pi, (b, T))
            .astype(np.float32),
            "gt_mask": rng.rand(b, T) > 0.2}


def crm_batch(seed, b=4):
    rng = np.random.RandomState(seed)
    pm = np.arange(T)[None] < np.array(track_lengths(b))[:, None]
    ious = rng.uniform(-0.2, 1.0, (b, T)).astype(np.float32)
    ious[ious < 0] = -1.0
    return {"query_pts": rng.randn(b, T, NP, 32).astype(np.float32),
            "pad_mask": pm, "gt_ious": ious}


BATCHES = {"grm": grm_batch, "prm": prm_batch, "crm": crm_batch}
INPUTS = {"grm": ("query_pts", "query_sizes", "memory_pts", "memory_mask"),
          "prm": ("query_pts", "query_boxes", "memory_pts", "pad_mask"),
          "crm": ("query_pts", "pad_mask")}


def ref_cfg(kind, cls="Vehicle"):
    """The model config tools/train_refine.py reads (plain dicts)."""
    m = {"NAME": NAMES[kind], "D_MODEL": D_MODEL}
    if kind != "crm":
        m.update(N_HEADS=HEADS, NUM_DECODER_LAYERS=1)
    if kind == "grm":
        m["SIZE_ANCHORS"] = ANCHORS.tolist()
    return {"CLASS_NAME": cls, "MODEL": m, "MEMORY_POINTS": NM,
            "POINT_FEATURES": 11 if kind == "grm" else 32}


def flax_variables(model, kind, seed=0):
    """The reference model's variables, every leaf perturbed (biases and
    LayerNorm affines away from 0 and 1), as numpy."""
    import jax

    b = BATCHES[kind](seed, 1)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed),
                            *(b[k][0] for k in INPUTS[kind]))
    rng = np.random.RandomState(seed + 100)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.randn(
        *np.shape(a))).astype(np.float32), v)


def moving_track(rng, t, dims=(4.4, 2.0, 1.6), n_pts=40, speed=1.5,
                 yaw=0.3, empty=()):
    """A rigid box moving along x with surface points in its own frame
    each step (frames in `empty` have none)."""
    boxes, pts = [], []
    c0 = rng.uniform(-20, 20, 2)
    for i in range(t):
        c = np.array([c0[0] + speed * i, c0[1], 0.5])
        boxes.append([*c, *dims, yaw + rng.randn() * 0.05])
        if i in empty:
            pts.append(np.zeros((0, 4), np.float32))
            continue
        local = rng.uniform(-0.5, 0.5, (n_pts, 3)) * np.asarray(dims)
        cs, sn = np.cos(yaw), np.sin(yaw)
        world = local.copy()
        world[:, 0] = local[:, 0] * cs - local[:, 1] * sn + c[0]
        world[:, 1] = local[:, 0] * sn + local[:, 1] * cs + c[1]
        world[:, 2] = local[:, 2] + c[2]
        pts.append(np.concatenate([world, rng.rand(n_pts, 1)], 1)
                   .astype(np.float32))
    return np.asarray(boxes, np.float32), pts


def object_records(seed, n=6, t=8):
    """Daemon-style records {oid: rec}: tracks of t frames (some frames
    without points), the GT boxes, per-row match flags (two tracks
    unmatched, one partly), CRM IoU labels and a frame index."""
    rng = np.random.RandomState(seed)
    out = {}
    for oid in range(n):
        boxes, pts = moving_track(rng, t, empty=(2,) if oid % 3 == 0 else ())
        gt = boxes.copy()
        gt[:, :2] += rng.randn(t, 2).astype(np.float32) * 0.2
        gt[:, 6] = 0.3
        matched = np.ones(t, bool)
        if oid in (1, 4):
            matched[:] = False
        if oid == 2:
            matched[::3] = False
        boxes[1::2, 6] += np.float32(np.pi)       # detector's pi-flips
        out[oid] = {"boxes_global": boxes, "score": rng.uniform(
            0.3, 1.0, t).astype(np.float32), "sample_idx": np.arange(t),
            "hit": np.ones(t, bool), "state": "dynamic", "label": 0,
            "pts": pts, "gt_boxes": gt, "matched": matched,
            "iou_gt": rng.uniform(0, 1, t).astype(np.float32)}
    return out

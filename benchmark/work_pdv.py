"""The PDV RoI head's work a frame, counted by the reference's own voxel
lists (`reference/pdv.py`) on the RoIs the program pooled, with the
widths of the model's weights (`shapes`, the state dict's), and the least
time the card could take for it (`work.bound_s`).

Operations (two a multiply-add), on the valid RoIs and the found
neighbours only: a level's pooling MLP, its two weights a found
neighbour; a RoI's attention, its projections (the density term, query,
key, value, output) a grid token and the logits and weighted sum,
2 * 2 * G^3 * G^3 * heads * head size; a RoI's shared layers and its
logit and residuals, their weights once.  Bytes, each input read once and
each output written once: the features (bf16) and centroids (f32) of the
distinct voxels found, the distinct BEV pixels the keypoints sample (bf16),
the RoIs (f32), the head's weights (bf16), the logits and residuals (f32).
"""

from __future__ import annotations

import math

import torch

from benchmark import work
from benchmark.reference import geometry, pdv

HEAD = "roi_head."


def _numel(shapes, *names):
    return sum(math.prod(shapes[HEAD + n]) for n in names)


def frame_work(points, valid, rois, mask, cfg, shapes):
    """One frame's RoI head on rois (R, 7), mask (R,): ops, bytes, and the
    found and distinct neighbours a level."""
    levels, _, _ = geometry.build_levels(points, valid, cfg)
    tables = pdv.tables(points, valid, levels, cfg)
    rois = rois[mask].float()
    n_roi = int(rois.shape[0])
    g3 = cfg["roi_grid_size"] ** 3
    pts = pdv.grid_points(rois, cfg["roi_grid_size"]).reshape(-1, 3)
    ops = n_bytes = 0.0
    found, distinct, width = [], [], 1
    for li, (lvl, stride) in enumerate(pdv.ROI_LEVELS):
        keys, fnd, _ = pdv.query(tables[lvl], pts, stride, cfg)
        found.append(int(fnd.sum()))
        distinct.append(int(keys[fnd].unique().numel()))
        mlp = (f"pool_mlp{li}.dense0.weight", f"pool_mlp{li}.dense1.weight")
        ops += 2.0 * _numel(shapes, *mlp) * found[-1]
        n_bytes += (2 * (shapes[HEAD + mlp[0]][1] - 3) + 4 * 3) \
            * distinct[-1]
        width += shapes[HEAD + mlp[1]][0]
    shared = ("shared_fc.dense0.weight", "shared_fc.dense1.weight",
              "cls.weight", "reg.weight")
    per_roi = 2.0 * _numel(shapes, *shared)
    if cfg["roi_attention"]:
        _, heads, dim = shapes[HEAD + "grid_attn.query.kernel"]
        per_roi += 2.0 * g3 * _numel(
            shapes, "density_pos.weight", "grid_attn.query.kernel",
            "grid_attn.key.kernel", "grid_attn.value.kernel",
            "grid_attn.out.kernel") + 4.0 * g3 * g3 * heads * dim
    ops += per_roi * n_roi
    bev_channels = (shapes[HEAD + shared[0]][1] - g3 * width) // pdv.KEYPOINTS
    h, w = cfg["bev_hw"]
    x0, y0, _, _ = pdv.bev_corners(pdv.keypoints_bev(rois).reshape(-1, 2),
                                   cfg, h, w)
    pixels = int(torch.cat([(y0 + dy) * w + x0 + dx for dy in (0, 1)
                            for dx in (0, 1)]).unique().numel())
    params = sum(math.prod(s) for k, s in shapes.items()
                 if k.startswith(HEAD) and not k.endswith((".mean", ".var")))
    code = shapes[HEAD + "reg.weight"][0]
    n_bytes += 2 * bev_channels * pixels + 4 * 7 * n_roi + 2 * params \
        + 4 * (1 + code) * n_roi
    return {"ops": ops, "bytes": n_bytes, "found": found,
            "distinct": distinct, "pixels": pixels, "rois": n_roi}


def bound_s(w):
    return work.bound_s(w["bytes"], w["ops"])

"""The work a frame needs, counted from the input by the reference's own
voxel sites (`reference/geometry.py`), never from the program's plan, and
the least time the card could take for it.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM
3.35 TB/s (the arithmetic is a frozen copy of `chip_smoke.bound`).

A sparse conv's operations are 2 * cin * cout per (occupied output site,
occupied input tap) pair.  Its bytes count each input value read once and
each output value written once, in bf16: the input sites some output reads
(cin each), the weight, the output sites (cout each); K2 adds its folded
batch-norm scale and bias (f32) and, on the residual convs, the residual at
the output sites.  The input gradient (K4 on the transposed maps) reads the
output gradient at the forward's outputs and writes the gradient at the
forward's inputs; the weight gradient (K5) reads the input and the output
gradient and writes the f32 (27, cin, cout) result.  Dense convs count
2 * cin * cout * k * k per output pixel.
"""

from __future__ import annotations

from benchmark.reference import geometry

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
CHANNELS = (16, 32, 64, 128)


def bound_s(n_bytes, ops):
    """The least time: the larger of bytes over the memory rate and
    operations over the bf16 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_BF16)


def _pairs(out_level, in_level, mode):
    idx = geometry.neighbours(out_level, in_level, mode)
    hit = idx < in_level.n_sites
    return {"pairs": int(hit.sum()),
            "n_read": int(idx[hit].unique().numel()),
            "n_out": out_level.n_sites}


def sparse_convs(levels, stem_cin):
    """The 20 sparse convs of the 3D backbone in order: dicts of name, cin,
    cout, residual, pairs, n_read (input sites read), n_out."""
    c = CHANNELS
    out = []
    sub = _pairs(levels[0], levels[0], "subm")
    out.append(dict(sub, name="stem", cin=stem_cin, cout=c[0],
                    residual=False))
    for lvl in range(4):
        if lvl > 0:
            out.append(dict(_pairs(levels[lvl], levels[lvl - 1], "down"),
                            name=f"down{lvl}", cin=c[lvl - 1], cout=c[lvl],
                            residual=False))
            sub = _pairs(levels[lvl], levels[lvl], "subm")
        for i in range(4):
            out.append(dict(sub, name=f"L{lvl}.{i}", cin=c[lvl], cout=c[lvl],
                            residual=i % 2 == 1))
    return out


def dense_flops(cfg):
    """Forward operations of the 2D BEV backbone and the center head, from
    their shapes."""
    grids = geometry.level_grids(cfg["grid"])
    nzf = grids[4][0]
    h, w = cfg["bev_hw"]
    flops = 0.0
    cin = CHANNELS[3] * nzf
    filters = (128, 256)
    for lvl, n in enumerate(cfg["bev_layer_nums"]):
        s = 2 if lvl == 1 else 1
        ho, wo = -(-h // s), -(-w // s)
        for k in range(n + 1):
            flops += 2 * cin * filters[lvl] * 9 * ho * wo
            cin = filters[lvl]
        # 1x1 conv back at stride 1, or the 2x2 transposed conv
        flops += 2 * cin * 256 * (1 if lvl == 0 else 4) * ho * wo
    n_heads = len(cfg["class_ids_each_head"])
    # heatmap, center 2, z 1, dims 3, rot 2, velocity 2, iou 1
    outs = sum(len(ids) + 11 for ids in cfg["class_ids_each_head"])
    flops += 2 * 512 * 64 * 9 * h * w                       # shared conv
    flops += n_heads * 7 * 2 * 64 * 64 * 9 * h * w          # head convs
    flops += 2 * 64 * outs * 9 * h * w                      # out convs
    return flops


def frame_work(levels, final_zmask, cfg, stem_cin):
    """One frame's counts: the sparse convs, the z-conv's pairs and the
    dense operations."""
    nz3 = levels[3].grid[0]
    zpairs = 0
    for t in range(3):
        z = 2 * final_zmask.nonzero()[:, 1] + t - 1
        zpairs += int(((z >= 0) & (z < nz3)).sum())
    return {"convs": sparse_convs(levels, stem_cin), "zconv_pairs": zpairs,
            "dense_flops": dense_flops(cfg)}


def conv_ops(c):
    return 2.0 * c["cin"] * c["cout"] * c["pairs"]


def _launches(works):
    """The frames of one launch group (a predicted frame, or a training
    step's frames, which share each launch) -> their convs summed."""
    out = []
    for convs in zip(*[w["convs"] for w in works]):
        c = dict(convs[0])
        for k in ("pairs", "n_read", "n_out"):
            c[k] = sum(x[k] for x in convs)
        out.append(c)
    return out


def k2_bound(works):
    """Eval convs (K2): the 20 sparse convs with the epilogue."""
    t = 0.0
    for c in _launches(works):
        n_bytes = (2 * c["n_read"] * c["cin"] + 2 * 27 * c["cin"] * c["cout"]
                   + 2 * c["n_out"] * c["cout"] + 8 * c["cout"]
                   + 2 * c["n_out"] * c["cout"] * c["residual"])
        t += bound_s(n_bytes, conv_ops(c))
    return t


def k4_bound(works):
    """Training convs (K4): the 20 forward convs and the 19 input
    gradients (not the stem's)."""
    t = 0.0
    for c in _launches(works):
        w = 2 * 27 * c["cin"] * c["cout"]
        t += bound_s(2 * c["n_read"] * c["cin"] + w
                     + 2 * c["n_out"] * c["cout"], conv_ops(c))
        if c["name"] != "stem":
            t += bound_s(2 * c["n_out"] * c["cout"] + w
                         + 2 * c["n_read"] * c["cin"], conv_ops(c))
    return t


def k5_bound(works):
    """Weight gradients (K5) of the 20 sparse convs."""
    return sum(bound_s(2 * c["n_read"] * c["cin"] + 2 * c["n_out"] * c["cout"]
                       + 4 * 27 * c["cin"] * c["cout"], conv_ops(c))
               for c in _launches(works))


def flops(work, train):
    """Useful operations of a frame: forward, and in training the input
    and weight gradients of every layer (the stem's input needs none)."""
    sparse = sum(conv_ops(c) for c in work["convs"])
    fwd = sparse + 2.0 * 128 * 128 * work["zconv_pairs"] \
        + work["dense_flops"]
    if not train:
        return fwd
    return 3 * fwd - conv_ops(work["convs"][0])

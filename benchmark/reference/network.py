"""The CenterPoint detector's network in plain PyTorch, float32.

The sparse 3D backbone runs on voxel lists (`geometry.py`): a conv gathers
each output site's 27 taps through the hashed neighbour index and
multiplies once by the (27 * cin, cout) weight.  The 2D BEV backbone and
the center head are dense `torch.nn.functional` convolutions with flax's
'SAME' padding.  Batch norm uses the running statistics in eval mode and
the batch's statistics (one-pass variance, over every site of the batch)
in train mode.

Weights come as a state dict with the detector's parameter names.  With
`prec=FP8` every conv's input and weight is rounded to float8 e4m3 (one
scale a tensor) before the product: the control of the comparison.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import geometry

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-3
CHANNELS = (16, 32, 64, 128)
HEADS = ("hm", "center", "center_z", "dim", "rot", "vel", "iou")


class F32:
    """Float32 throughout."""

    @staticmethod
    def q(t):
        return t


class FP8:
    """Rounds a tensor to float8 e4m3 with one scale, its max over 448."""

    @staticmethod
    def q(t):
        amax = t.detach().abs().max()
        if float(amax) == 0.0:
            return t
        s = amax / 448.0
        return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def batch_norm(x, sd, prefix, ch_dim, train):
    """x normalised along `ch_dim` (train: the batch's statistics over every
    other axis, recorded into `sd["_stats"]` where that dict is given;
    eval: the running ones)."""
    scale, bias = sd[prefix + ".scale"], sd[prefix + ".bias"]
    shape = [1] * x.ndim
    shape[ch_dim] = -1
    if train:
        dims = tuple(d for d in range(x.ndim) if d != ch_dim)
        n = max(x.numel() // x.shape[ch_dim], 1)
        mean = x.sum(dims) / n
        var = torch.clamp((x * x).sum(dims) / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + BN_EPS)
        if "_stats" in sd:
            sd["_stats"][prefix] = (mean.detach(), var.detach())
        return ((x - mean.reshape(shape)) * rstd.reshape(shape)
                * scale.reshape(shape) + bias.reshape(shape))
    sc = scale * torch.rsqrt(sd[prefix + ".var"] + BN_EPS)
    bi = bias - sd[prefix + ".mean"] * sc
    return x * sc.reshape(shape) + bi.reshape(shape)


def sparse_conv(feats, idx, weight, prec):
    """feats (V_in, cin), idx (V_out, 27) with V_in for "no site", weight
    (27, cin, cout) -> (V_out, cout)."""
    cin = feats.shape[1]
    padded = torch.cat([prec.q(feats), feats.new_zeros(1, cin)])
    taps = padded[idx].reshape(idx.shape[0], 27 * cin)
    return taps @ prec.q(weight).reshape(27 * cin, -1)


def _cat_idx(idxs, n_ins):
    """Per-sample neighbour indices -> one index into the samples' sites
    laid end to end, the absent taps pointing past the end."""
    total = sum(n_ins)
    out, off = [], 0
    for idx, n in zip(idxs, n_ins):
        out.append(torch.where(idx < n, idx + off, torch.full_like(idx,
                                                                   total)))
        off += n
    return torch.cat(out)


def backbone3d(sd, frames, cfg, train, prec):
    """frames: per sample (levels, final_zmask, stem_in) of
    `geometry.build_levels`.  Returns the BEV maps (N, ny_f, nx_f,
    nz_f * 128), channel z * 128 + c."""
    p = "backbone3d."
    levels = [f[0] for f in frames]

    def idx_of(lvl_out, lvl_in, mode):
        return _cat_idx(
            [geometry.neighbours(lv[lvl_out], lv[lvl_in], mode)
             for lv in levels],
            [lv[lvl_in].n_sites for lv in levels])

    def conv_bn(x, idx, name, act=True, residual=None):
        y = sparse_conv(x, idx, sd[name + ".kernel"], prec)
        y = batch_norm(y, sd, name + ".MaskedBatchNorm_0", 1, train)
        if residual is not None:
            return torch.relu(y + residual)
        return torch.relu(y) if act else y

    x = torch.cat([f[2] for f in frames])
    sub = idx_of(0, 0, "subm")
    x = conv_bn(x, sub, p + "SparseConvBNReLU_0")
    block = 0
    for lvl in range(4):
        if lvl > 0:
            x = conv_bn(x, idx_of(lvl, lvl - 1, "down"),
                        p + f"SparseConvBNReLU_{lvl}")
            sub = idx_of(lvl, lvl, "subm")
        for _ in range(2):
            name = p + f"SparseBasicBlock_{block}"
            y = conv_bn(x, sub, name + ".SparseConvBNReLU_0")
            x = conv_bn(y, sub, name + ".SparseConvBNReLU_1", residual=x)
            block += 1

    # the (3, 1, 1) z-stride conv over every level-3 pillar, then densify
    w = sd[p + "SparseConvBNReLU_4.kernel"]
    grids = geometry.level_grids(cfg["grid"])
    nz3, c3 = grids[3][0], CHANNELS[3]
    onz, ony, onx = grids[4]
    dense, masks, off = [], [], 0
    for lv, (_, final_zmask, _) in zip(levels, frames):
        l3 = lv[3]
        d = x.new_zeros(l3.cells.shape[0], nz3, c3)
        n = l3.n_sites
        d = d.index_put((l3.site_pillar, l3.site_z), x[off:off + n])
        off += n
        dense.append(d)
        masks.append(final_zmask)
    d = torch.cat(dense)
    m = torch.cat(masks)
    dp = F.pad(prec.q(d), (0, 0, 1, 1))
    wq = prec.q(w)
    out = 0.0
    for t in range(3):
        out = out + dp[:, t:t + 2 * (onz - 1) + 1:2] @ wq[t]
    sel = m[..., None]
    out = torch.where(sel, out, 0.0)
    name = p + "SparseConvBNReLU_4.MaskedBatchNorm_0"
    if train:
        # statistics over the final sites only
        vals = out[m]
        vals = batch_norm(vals, sd, name, 1, True)
        out = out.new_zeros(out.shape).index_put(torch.nonzero(
            m, as_tuple=True), torch.relu(vals))
    else:
        out = torch.where(sel, torch.relu(batch_norm(out, sd, name, 2,
                                                     False)), 0.0)
    bev, off = [], 0
    for lv in levels:
        cells = lv[3].cells
        n = cells.shape[0]
        flat = out.new_zeros(ony * onx, onz * c3)
        flat = flat.index_put((cells,), out[off:off + n].reshape(n, -1))
        off += n
        bev.append(flat.reshape(ony, onx, -1))
    return torch.stack(bev)


def same_conv(x, w, bias, stride, prec):
    """flax 'SAME' conv on NCHW."""
    k = w.shape[-1]
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(prec.q(x), pads)
    return F.conv2d(x, prec.q(w), bias, stride)


def conv_bn_relu(x, sd, name, stride, train, prec):
    y = same_conv(x, sd[name + ".Conv_0.weight"], None, stride, prec)
    return torch.relu(batch_norm(y, sd, name + ".MaskedBatchNorm_0", 1,
                                 train))


def backbone2d(sd, bev, cfg, train, prec):
    """(N, H, W, C) -> (N, 512, H, W): two conv stacks at strides 1 and 2,
    each brought back to H x W (1x1 conv, 2x2 transposed conv) and
    concatenated."""
    p = "backbone2d."
    x = bev.permute(0, 3, 1, 2)
    ups, conv_i = [], 0
    layer_nums = cfg["bev_layer_nums"]
    for lvl, n_layers in enumerate(layer_nums):
        for k in range(n_layers + 1):
            x = conv_bn_relu(x, sd, p + f"ConvBNReLU_{conv_i}",
                             2 if (lvl == 1 and k == 0) else 1, train, prec)
            conv_i += 1
        if lvl == 0:
            u = same_conv(x, sd[p + "Conv_0.weight"], None, 1, prec)
        else:
            u = F.conv_transpose2d(prec.q(x), prec.q(
                sd[p + "ConvTranspose_0.weight"]), None, 2)
        ups.append(torch.relu(batch_norm(u, sd, p + f"MaskedBatchNorm_{lvl}",
                                         1, train)))
    return torch.cat(ups, 1)


def center_head(sd, x, cfg, train, prec):
    """(N, 512, H, W) -> per head {name: (N, H, W, ch)}."""
    p = "center_head."
    x = conv_bn_relu(x, sd, p + "shared_conv", 1, train, prec)
    out = []
    for h in range(len(cfg["class_ids_each_head"])):
        maps = {}
        for name in HEADS:
            if (name == "vel" and not cfg["with_velocity"]) or (
                    name == "iou" and not cfg["with_iou"]):
                continue
            hp = p + f"head{h}.{name}"
            y = conv_bn_relu(x, sd, hp + "_conv0", 1, train, prec)
            y = same_conv(y, sd[hp + "_out.weight"], sd[hp + "_out.bias"], 1,
                          prec)
            maps[name] = y.permute(0, 2, 3, 1)
        out.append(maps)
    return out


def forward(sd, points, valid, cfg, train=False, prec=F32):
    """points (N, P, F), valid (N, P) -> (per-head maps (N, H, W, ch), the
    frames' geometry)."""
    frames = [geometry.build_levels(pt, v, cfg)
              for pt, v in zip(points, valid)]
    bev = backbone3d(sd, frames, cfg, train, prec)
    maps = center_head(sd, backbone2d(sd, bev, cfg, train, prec), cfg,
                       train, prec)
    return maps, frames

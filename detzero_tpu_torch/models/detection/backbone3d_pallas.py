"""Sparse residual 3D backbone on the row-padded pillar layout (port of the
reference's backbone3d_pallas.py).

Eval mode: all 20 3x3x3 convs run through kernel K2 (`ops/rowpad_conv.py`),
which applies the folded BN, the residual, the ReLU and the zmask in its
epilogue.  Train mode: each conv is `RowpadConv` (kernel K4 forward, or K9
for the 17 'subm' convs under `rowpad_conv.USE_SLIDING`; K4 and K5
backward) followed by the masked batch-statistics BN, the ReLU, the
zmask and the residual as torch ops (`backbone3d_pallas.py:162-177`).  The
final (3,1,1) z-conv and the BEV densify run on the compact table.  With
`with_multi_scale` (the PDV second stage) the backbone also returns the
compact tables of levels 2 and 3 (`x_conv3`, `x_conv4`), per sample.

A batch runs as one table: the samples' row-padded tables and neighbour
maps are stacked along the BEV-row axis (`stack_plans`), so each conv is one
launch for the batch and each BN's statistics span the batch, as the
reference's psum over the vmapped batch axis gives them.  This is exact:
every level has ny_in = 2 * ny_out, and each sample's maps already mark
absent every tap that would cross its first or last row.

Module names follow flax's auto-names, so `convert.py` maps the reference's
param tree one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from detzero_tpu_torch.models.detection.backbone3d_pillar import plan_grids
from detzero_tpu_torch.models.layers import AutoNames, MaskedBatchNorm
from detzero_tpu_torch.ops import pillars
from detzero_tpu_torch.ops.rowpad_conv import RowpadConv, rowpad_conv_fused
from detzero_tpu_torch.ops.rowpad_nbr import rowpad_nbr_maps


def augment_plan_rowpad(plan, grid_zyx, row_budget: int = 128):
    """Add the row-padded structures to a `build_pillar_plan` plan: per level
    rp_slot, rp_keep, rp_gidx, rp_gvalid, rp_zmask (ny, nz, B), rp_nbr
    (ny, 16, B); for levels 0..2 also rp_down_nbr (at the output grid) and
    rp_up_nbr (this grid; the strided conv's transpose, which the training
    slice consumes).  The 10 neighbour maps come from kernel K8
    (`ops/rowpad_nbr.py`), one launch on the card.  Returns new level
    dicts."""
    grids = plan_grids(grid_zyx)
    out = [dict(e) for e in plan]
    xq = []
    for lvl in range(4):
        nz, ny, nx = grids[lvl]
        e = out[lvl]
        lay = pillars.rowpad_layout(e["cells"], e["mask"], (ny, nx),
                                    row_budget)
        e["rp_slot"], e["rp_keep"] = lay["slot"], lay["keep"]
        e["rp_gidx"], e["rp_gvalid"] = lay["gidx"], lay["gvalid"]
        e["rp_zmask"] = pillars.rowpad_gather(
            e["zmask"].to(torch.int8), lay["gidx"], lay["gvalid"]) > 0
        xq.append(pillars.rowpad_xcoords(e["coords2d"][:, 1], lay["gidx"],
                                         lay["gvalid"]))
    cases = [(lvl, "rp_nbr", (xq[lvl], xq[lvl], "subm")) for lvl in range(4)]
    for lvl in range(3):
        cases += [(lvl, "rp_down_nbr", (xq[lvl + 1], xq[lvl], "down")),
                  (lvl, "rp_up_nbr", (xq[lvl], xq[lvl + 1], "up"))]
    maps = rowpad_nbr_maps([c for _, _, c in cases])
    for (lvl, key, _), nbr in zip(cases, maps):
        out[lvl][key] = nbr
    return out


_RP_STACKED = ("rp_zmask", "rp_nbr", "rp_down_nbr", "rp_up_nbr")
# what the second stage reads of levels 2 and 3, per sample
_SAMPLE_KEYS = ("cells", "mask", "zmask", "lut", "centroids")


def stack_plans(plans):
    """Per-sample rowpad plans -> one plan for the batch: levels 0..3 carry
    the row-padded zmasks and neighbour maps stacked along the BEV-row axis
    (ranks stay row-local, so the maps need no offset); level 3 the
    compact slots of every sample into the stacked table, for the z-conv;
    with centroids in the plans (the second stage), levels 2 and 3 also
    the slots and the samples' cells, masks, zmasks, row LUTs and
    centroids stacked along a leading batch axis, for the multi-scale
    tables, whose voxel query probes one sample at a time; the final level
    the samples' compact zmasks concatenated plus their cells and masks
    stacked (B, MP) for the per-sample densify."""
    out = [{k: torch.cat([p[lvl][k] for p in plans]) for k in _RP_STACKED
            if k in plans[0][lvl]} for lvl in range(4)]
    multi_scale = "centroids" in plans[0][3]
    for lvl in (2, 3) if multi_scale else (3,):
        zm = plans[0][lvl]["rp_zmask"]
        rows = zm.shape[0] * zm.shape[2]        # slots of one sample
        out[lvl]["rp_slot"] = torch.cat([p[lvl]["rp_slot"] + b * rows
                                         for b, p in enumerate(plans)])
        out[lvl]["rp_keep"] = torch.cat([p[lvl]["rp_keep"] for p in plans])
        if multi_scale:
            out[lvl].update({k: torch.stack([p[lvl][k] for p in plans])
                             for k in _SAMPLE_KEYS})
    out.append({"zmask": torch.cat([p[4]["zmask"] for p in plans]),
                "cells": torch.stack([p[4]["cells"] for p in plans]),
                "mask": torch.stack([p[4]["mask"] for p in plans])})
    return out


class SparseConvBNReLU(nn.Module):
    """One sparse conv + BN (+ ReLU).  kernel_volume 27: the row-padded conv
    (eval: kernel K2 with the folded BN; train: `RowpadConv` and the masked
    batch BN); 3: the (3,1,1) z-stride conv on the compact table."""

    def __init__(self, cin, features, kernel_volume, act=True, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_volume, cin, features,
                                               device=device))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, device=device)
        self.act = act

    def forward(self, x, zmask, nbr=None, *, nz=None, out_nz=None,
                mode="subm", z_stride=1, residual=None, fuse_relu=False,
                nbr_up=None, zmask_in=None):
        """zmask: the output level's; nbr_up (train, 'down'): the transpose
        map for the input gradient; zmask_in (train): the input level's
        zmask, where the input gradient is needed (default: zmask for
        'subm')."""
        kv, cin, cout = self.kernel.shape
        if kv == 3:
            # x: compact (MP, nz, C); zmask: the output level's compact zmask
            y = pillars.z_conv(x.float(), zmask,
                               self.kernel.to(x.dtype).float(), 2, out_nz)
            m = zmask[:, :y.shape[1], None]
            y = self.MaskedBatchNorm_0(y, mask=m).to(x.dtype)
            if self.act:
                y = torch.relu(y)
            return torch.where(m, y, 0.0)
        if not self.training:
            sc, bi = self.MaskedBatchNorm_0.affine()
            return rowpad_conv_fused(
                x, nbr, self.kernel, sc, bi, zmask, residual, nz=nz,
                cin=cin, cout=cout, z_stride=z_stride, out_nz=out_nz,
                mode=mode, relu=self.act or fuse_relu)
        onz = out_nz if out_nz is not None else nz
        if zmask_in is None and mode == "subm":
            zmask_in = zmask
        y = RowpadConv.apply(x, self.kernel, nbr,
                             nbr if nbr_up is None else nbr_up,
                             zmask[:, :onz], zmask_in, nz, cin, cout,
                             z_stride, onz, mode)
        ny_o, _, b = y.shape
        m4 = zmask[:, :onz, None, :]
        y = self.MaskedBatchNorm_0(y.reshape(ny_o, onz, cout, b),
                                   channel_dim=2, mask=m4)
        if self.act:
            y = torch.relu(y)
        y = torch.where(m4, y, 0.0).reshape(ny_o, onz * cout, b)
        if residual is not None:
            y = torch.relu(y + residual.to(y.dtype))
        return y


class SparseBasicBlock(nn.Module):
    """Residual pair of submanifold convs; the second conv's epilogue adds
    the skip and applies the final ReLU."""

    def __init__(self, features, device=None):
        super().__init__()
        self.SparseConvBNReLU_0 = SparseConvBNReLU(features, features, 27,
                                                   act=True, device=device)
        self.SparseConvBNReLU_1 = SparseConvBNReLU(features, features, 27,
                                                   act=False, device=device)

    def forward(self, x, zmask, nbr, nz):
        y = self.SparseConvBNReLU_0(x, zmask, nbr, nz=nz)
        return self.SparseConvBNReLU_1(y, zmask, nbr, nz=nz, residual=x,
                                       fuse_relu=True)


class PallasResBackbone8x(nn.Module):
    """[16, 32, 64, 128]-channel sparse residual backbone with 8x BEV
    downsampling.  forward(rp_feats (n*ny, nz*F, B) of n samples stacked,
    `stack_plans` of their plans) -> {"spatial_features": BEV maps
    (n, H/8, W/8, C*nz_final), "multi_scale_3d_features": {} or, with
    `with_multi_scale`, per level "x_conv3" (stride 4) and "x_conv4"
    (stride 8) the compact output table of the level's blocks, features
    (n, MP*nz, C) with row p*nz + z for pillar p, and the plan's cells,
    mask, zmask, lut and centroids of the level, each (n, ...)}."""

    def __init__(self, grid_zyx, in_features, channels: Sequence[int] = (
            16, 32, 64, 128), blocks_per_level=2, residual=True,
            with_multi_scale=False, device=None):
        super().__init__()
        self.grid_zyx = tuple(grid_zyx)
        self.channels = tuple(channels)
        self.with_multi_scale = bool(with_multi_scale)
        name = AutoNames()
        self.stem = name("SparseConvBNReLU")
        self.add_module(self.stem, SparseConvBNReLU(
            in_features, channels[0], 27, device=device))
        self.blocks, self.downs = [], []
        for lvl in range(4):
            names = []
            for _ in range(blocks_per_level):
                if residual:
                    names.append(name("SparseBasicBlock"))
                    mod = SparseBasicBlock(channels[lvl], device=device)
                else:
                    names.append(name("SparseConvBNReLU"))
                    mod = SparseConvBNReLU(channels[lvl], channels[lvl], 27,
                                           device=device)
                self.add_module(names[-1], mod)
            self.blocks.append(names)
            if lvl < 3:
                self.downs.append(name("SparseConvBNReLU"))
                self.add_module(self.downs[-1], SparseConvBNReLU(
                    channels[lvl], channels[lvl + 1], 27, device=device))
        self.zconv = name("SparseConvBNReLU")
        self.add_module(self.zconv, SparseConvBNReLU(
            channels[3], channels[3], 3, device=device))

    def forward(self, rp_feats, plan):
        grids = plan_grids(self.grid_zyx)
        nz0 = grids[0][0]
        x = getattr(self, self.stem)(rp_feats, plan[0]["rp_zmask"],
                                     plan[0]["rp_nbr"], nz=nz0)
        multi_scale = {}
        for lvl in range(4):
            e = plan[lvl]
            nz = grids[lvl][0]
            for name in self.blocks[lvl]:
                x = getattr(self, name)(x, e["rp_zmask"], e["rp_nbr"], nz=nz)
            if self.with_multi_scale and lvl >= 2:
                n, mp = e["cells"].shape
                multi_scale[f"x_conv{lvl + 1}"] = dict(
                    {k: e[k] for k in _SAMPLE_KEYS if k in e},
                    features=pillars.from_rowpad(
                        x, e["rp_slot"], e["rp_keep"]).reshape(
                        n, mp * nz, self.channels[lvl]))
            if lvl < 3:
                x = getattr(self, self.downs[lvl])(
                    x, plan[lvl + 1]["rp_zmask"], e["rp_down_nbr"], nz=nz,
                    out_nz=grids[lvl + 1][0], mode="down", z_stride=2,
                    nbr_up=e.get("rp_up_nbr"), zmask_in=e["rp_zmask"])
        l3, final = plan[3], plan[4]
        nz3, c3 = grids[3][0], x.shape[1] // grids[3][0]
        n, mp3 = final["cells"].shape
        if "x_conv4" in multi_scale:
            xc = multi_scale["x_conv4"]["features"]
        else:
            xc = pillars.from_rowpad(x, l3["rp_slot"], l3["rp_keep"])
        xz = getattr(self, self.zconv)(xc.reshape(n * mp3, nz3, c3),
                                       final["zmask"], out_nz=grids[4][0])
        xz = xz.reshape(n, mp3, -1)
        bev = torch.stack([pillars.densify_pillars(
            xz[b], final["cells"][b], final["mask"][b],
            (grids[4][1], grids[4][2])) for b in range(n)])
        return {"spatial_features": bev,
                "multi_scale_3d_features": multi_scale}

"""Sparse residual 3D backbone on the row-padded pillar layout, eval mode
(port of the reference's backbone3d_pallas.py).

All 20 3x3x3 convs run through kernel K2 (`ops/rowpad_conv.py`), which
applies the folded BN, the residual, the ReLU and the zmask in its epilogue;
the final (3,1,1) z-conv and the BEV densify run on the compact table.
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
from detzero_tpu_torch.ops.rowpad_conv import rowpad_conv_fused


def augment_plan_rowpad(plan, grid_zyx, row_budget: int = 128):
    """Add the row-padded structures to a `build_pillar_plan` plan: per level
    rp_slot, rp_keep, rp_gidx, rp_gvalid, rp_zmask (ny, nz, B), rp_nbr
    (ny, 16, B); for levels 0..2 also rp_down_nbr (at the output grid) and
    rp_up_nbr (this grid; the strided conv's transpose, which the training
    slice consumes).  Returns new level dicts."""
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
        e["rp_nbr"] = pillars.rowpad_nbr_rank(xq[lvl], xq[lvl], mode="subm")
    for lvl in range(3):
        out[lvl]["rp_down_nbr"] = pillars.rowpad_nbr_rank(
            xq[lvl + 1], xq[lvl], mode="down")
        out[lvl]["rp_up_nbr"] = pillars.rowpad_nbr_rank(
            xq[lvl], xq[lvl + 1], mode="up")
    return out


class SparseConvBNReLU(nn.Module):
    """One sparse conv + eval BN (+ ReLU).  kernel_volume 27: the fused
    row-padded conv (kernel K2); 3: the (3,1,1) z-stride conv on the compact
    table."""

    def __init__(self, cin, features, kernel_volume, act=True, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_volume, cin, features,
                                               device=device))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, device=device)
        self.act = act

    def forward(self, x, zmask, nbr=None, *, nz=None, out_nz=None,
                mode="subm", z_stride=1, residual=None, fuse_relu=False):
        kv, cin, cout = self.kernel.shape
        if kv == 3:
            # x: compact (MP, nz, C); zmask: the output level's compact zmask
            y = pillars.z_conv(x.float(), zmask,
                               self.kernel.to(x.dtype).float(), 2, out_nz)
            y = self.MaskedBatchNorm_0(y).to(x.dtype)
            if self.act:
                y = torch.relu(y)
            return torch.where(zmask[:, :y.shape[1], None], y, 0.0)
        sc, bi = self.MaskedBatchNorm_0.affine()
        return rowpad_conv_fused(
            x, nbr, self.kernel, sc, bi, zmask, residual, nz=nz,
            cin=cin, cout=cout, z_stride=z_stride, out_nz=out_nz, mode=mode,
            relu=self.act or fuse_relu)


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
    downsampling.  forward(rp_feats (ny, nz*F, B), plan with rowpad) ->
    BEV map (H/8, W/8, C*nz_final)."""

    def __init__(self, grid_zyx, in_features, channels: Sequence[int] = (
            16, 32, 64, 128), blocks_per_level=2, residual=True,
            device=None):
        super().__init__()
        self.grid_zyx = tuple(grid_zyx)
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
        for lvl in range(4):
            e = plan[lvl]
            nz = grids[lvl][0]
            for name in self.blocks[lvl]:
                x = getattr(self, name)(x, e["rp_zmask"], e["rp_nbr"], nz=nz)
            if lvl < 3:
                x = getattr(self, self.downs[lvl])(
                    x, plan[lvl + 1]["rp_zmask"], e["rp_down_nbr"], nz=nz,
                    out_nz=grids[lvl + 1][0], mode="down", z_stride=2)
        l3, final = plan[3], plan[4]
        nz3, c3 = grids[3][0], x.shape[1] // grids[3][0]
        mp3 = l3["cells"].shape[0]
        xc = pillars.from_rowpad(x, l3["rp_slot"], l3["rp_keep"]).reshape(
            mp3, nz3, c3)
        xz = getattr(self, self.zconv)(xc, final["zmask"],
                                       out_nz=grids[4][0])
        return pillars.densify_pillars(xz.reshape(mp3, -1), final["cells"],
                                       final["mask"],
                                       (grids[4][1], grids[4][2]))

"""PDV second-stage RoI head (port of `detzero_tpu/models/detection/
pdv_head.py`): grid pooling over the backbone's multi-scale tables, the
grid-token attention, the refinement heads, and the RoI targets,
subsampling, loss and refined predictions.

Shapes are static, as in the reference: R proposals per sample (the first
stage's post-NMS boxes, masked), a G^3 grid of points per RoI, 16 neighbour
voxels per grid point and level.  The batch runs through one `PDVHead`
call: the voxel query probes each sample's own row LUT, then the rows of
all samples go through the MLPs together, so each masked BatchNorm spans
the batch, as the reference's psum over its vmapped batch axis gives it.

The RoI targets take the N x M 3D IoU of kernel K7
(`ops/iou3d.boxes_iou3d`), one launch per sample.  `subsample_rois` takes
its random numbers as tensors (three uniforms per RoI and one integer draw
per slot), so a test can hand it the reference's `jax.random` draws.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from detzero_tpu_torch.core import profiling
from detzero_tpu_torch.models.layers import (
    MLP, LayerNorm, Linear, MultiHeadDotProductAttention,
)
from detzero_tpu_torch.ops import pillars
from detzero_tpu_torch.ops.box_coder import ResidualCoder
from detzero_tpu_torch.ops.box_ops import rotate_points_along_z
from detzero_tpu_torch.ops.iou3d import boxes_iou3d
from detzero_tpu_torch.ops.losses import corner_loss_lidar, weighted_smooth_l1


def roi_grid_points(rois, grid_size: int):
    """(R, 7) -> (R, G^3, 3) grid-point centres of each RoI, world frame."""
    g = grid_size
    ar = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                      -1).reshape(-1, 3).float()
    local = ((idx + 0.5) / g - 0.5)[None] * rois[:, None, 3:6]
    return rotate_points_along_z(local, rois[:, 6]) + rois[:, None, :3]


class PDVHead(nn.Module):
    """Grid pooling + refinement heads.  forward(rois (N, R, 7), roi_mask
    (N, R), levels, extra_feats (N, R, E)) -> (cls_logit (N, R), reg_deltas
    (N, R, code_size)), both float32.  `levels`: one dict per pooled level,
    as `PallasResBackbone8x`'s multi-scale outputs give them (features,
    zmask, lut, centroids, each with a leading batch axis) plus `stride` and
    `grid_zyx`.  The head computes in extra_feats' dtype (the model's) and
    reads its inputs as they are: the caller detaches them, as the
    reference stops their gradient."""

    def __init__(self, pc_range, voxel_size, level_channels: Sequence[int],
                 extra_channels: int, grid_size=6,
                 mlp_channels: Sequence[int] = (32, 32),
                 shared_channels: Sequence[int] = (256, 256), nsample=16,
                 code_size=7, with_attention=False, attn_heads=4,
                 device=None):
        super().__init__()
        self.pc_min = tuple(float(v) for v in pc_range[:3])
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.grid_size = int(grid_size)
        self.nsample = int(nsample)
        self.with_attention = bool(with_attention)
        for li, c in enumerate(level_channels):
            self.add_module(f"pool_mlp{li}", MLP(c + 3, mlp_channels,
                                                 device=device))
        width = mlp_channels[-1] * len(level_channels) + 1
        if self.with_attention:
            qkv = -(-width // attn_heads) * attn_heads
            self.density_pos = Linear(1, width, device=device)
            self.grid_attn = MultiHeadDotProductAttention(
                width, attn_heads, qkv, device=device)
            self.LayerNorm_0 = LayerNorm(width, device=device)
        self.shared_fc = MLP(self.grid_size ** 3 * width + extra_channels,
                             shared_channels, device=device)
        self.cls = Linear(shared_channels[-1], 1, device=device)
        self.reg = Linear(shared_channels[-1], code_size, device=device)

    def forward(self, rois, roi_mask, levels, extra_feats):
        n, r = roi_mask.shape
        g3 = self.grid_size ** 3
        dtype = extra_feats.dtype
        grid = roi_grid_points(rois.reshape(n * r, 7), self.grid_size)
        flat = grid.reshape(n, r * g3, 3)
        pc_min = torch.tensor(self.pc_min, device=rois.device)
        vs = torch.tensor(self.voxel_size, device=rois.device)
        pooled, density = [], 0.0
        for li, lvl in enumerate(levels):
            with profiling.span("pool", "level", li):
                h, found = self._pool(li, lvl, flat, pc_min, vs, dtype)
                pooled.append(h)
                density = density + found.sum(1, keepdim=True).float()
        log_density = torch.log1p(density).to(dtype)
        pooled = torch.cat(pooled + [log_density], -1).reshape(n * r, g3, -1)
        if self.with_attention:
            with profiling.span("attention"):
                dpos = self.density_pos(log_density.reshape(n * r, g3, 1))
                q = pooled + dpos
                pooled = self.LayerNorm_0(pooled
                                          + self.grid_attn(q, q, pooled))
        with profiling.span("shared fc"):
            h = torch.cat([pooled.reshape(n * r, -1),
                           extra_feats.reshape(n * r, -1)], -1)
            h = self.shared_fc(h, roi_mask.reshape(-1)).float()
            cls = self.cls(h)[:, 0].reshape(n, r)
            reg = self.reg(h).reshape(n, r, -1)
        return cls, reg

    def _pool(self, li, lvl, flat, pc_min, vs, dtype):
        """Level li's pooled features (n * M, C) of the grid points flat
        (n, M, 3), and which of their neighbours were found (n * M,
        nsample): the voxel query of each sample, the gather, the masked
        MLP and the max."""
        n = flat.shape[0]
        nz, ny, nx = lvl["grid_zyx"]
        coords = torch.floor((flat - pc_min) / (vs * lvl["stride"])).to(
            torch.int32).flip(-1)
        hi = torch.tensor([nz - 1, ny - 1, nx - 1], dtype=torch.int32,
                          device=flat.device)
        coords = torch.minimum(torch.clamp(coords, min=0), hi)
        feats, rel, found = [], [], []
        for b in range(n):
            zm = lvl["zmask"][b].reshape(-1)
            idx, fnd = pillars.voxel_query_pillar(
                coords[b], lvl["lut"][b], zm, nz, (ny, nx), max_range=1,
                nsample=self.nsample)
            idx = idx.long()
            found.append(fnd & zm[idx])
            feats.append(lvl["features"][b][idx])
            centres = lvl["centroids"][b].reshape(-1, 3)[idx]
            rel.append(centres - flat[b][:, None, :])
        found = torch.cat(found)
        h = torch.cat([torch.cat(feats).to(dtype),
                       torch.cat(rel).to(dtype)], -1)
        h = getattr(self, f"pool_mlp{li}")(h, found)
        h = torch.where(found[..., None], h, float("-inf")).amax(1)
        return torch.where(torch.isfinite(h), h, 0.0), found


# ----------------------------------------------------------------------

def assign_roi_targets(rois, roi_mask, gt_boxes, gt_valid,
                       reg_fg_thresh: float = 0.55,
                       cls_fg_thresh: float = 0.75,
                       cls_bg_thresh: float = 0.25, coder=None):
    """One sample's RoI targets: rois (R, 7), gt_boxes (M, 7+), gt_valid
    (M,).  Each RoI's best-IoU GT (invalid GT at IoU -1), the cls target
    ramping from 0 at IoU 0.25 to 1 at 0.75, fg above 0.55, and the GT
    encoded against the RoI."""
    coder = coder or ResidualCoder()
    iou = boxes_iou3d(rois[:, :7], gt_boxes[:, :7])
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best, gt_idx = iou.max(1)
    matched = gt_boxes[gt_idx][:, :7]
    cls_t = torch.clamp((best - cls_bg_thresh)
                        / (cls_fg_thresh - cls_bg_thresh), 0.0, 1.0)
    return {"cls_target": cls_t,
            "reg_target": coder.encode(matched, rois[:, :7]),
            "fg_mask": (best > reg_fg_thresh) & roi_mask,
            "roi_iou": best, "matched_gt": matched}


def subsample_rois(roi_iou, roi_mask, uniforms, draw,
                   roi_per_image: int = 128, fg_ratio: float = 0.5,
                   reg_fg_thresh: float = 0.55, cls_fg_thresh: float = 0.75,
                   cls_bg_thresh_lo: float = 0.1, hard_bg_ratio: float = 0.8):
    """Static-shape fg/bg RoI subsampling of one sample (reference
    proposal_target_layer semantics): up to fg_ratio * M foreground RoIs
    (IoU >= min(reg_fg, cls_fg)) drawn without replacement, wrapping only
    when foreground alone fills the M slots; the rest background, split
    hard_bg_ratio hard (IoU in [lo, reg_fg)) against easy (IoU < lo), each
    drawn with replacement.  uniforms (3, R) in [0, 1) shuffle the fg, hard
    and easy pools; draw (M,) nonnegative integers pick the background.
    Returns (idx (M,) int32, valid (M,)); a slot whose pool is empty is
    invalid."""
    m = int(roi_per_image)
    dev = roi_iou.device
    fg = (roi_iou >= min(reg_fg_thresh, cls_fg_thresh)) & roi_mask
    easy = (roi_iou < cls_bg_thresh_lo) & roi_mask
    hard = (roi_iou >= cls_bg_thresh_lo) & (roi_iou < reg_fg_thresh) \
        & roi_mask
    fg_cnt, hard_cnt, easy_cnt = fg.sum(), hard.sum(), easy.sum()
    zero = torch.zeros((), dtype=fg_cnt.dtype, device=dev)
    n_fg = torch.where(hard_cnt + easy_cnt > 0,
                       torch.clamp(fg_cnt, max=int(round(fg_ratio * m))),
                       torch.where(fg_cnt > 0, zero + m, zero))
    n_bg = m - n_fg
    n_hard = torch.where(
        (hard_cnt > 0) & (easy_cnt > 0),
        torch.minimum((n_bg.float() * hard_bg_ratio).to(n_bg.dtype),
                      hard_cnt),
        torch.where(hard_cnt > 0, n_bg, zero))

    def pool(sel, u):
        return torch.argsort(torch.where(sel, u, 2.0), stable=True)

    fg_pool = pool(fg, uniforms[0])
    hard_pool = pool(hard, uniforms[1])
    easy_pool = pool(easy, uniforms[2])
    slots = torch.arange(m, device=dev)
    draw = draw.long()
    is_fg = slots < n_fg
    is_hard = ~is_fg & (slots < n_fg + n_hard)
    idx = torch.where(
        is_fg, fg_pool[slots % torch.clamp(fg_cnt, min=1)],
        torch.where(is_hard, hard_pool[draw % torch.clamp(hard_cnt, min=1)],
                    easy_pool[draw % torch.clamp(easy_cnt, min=1)]))
    valid = torch.where(is_fg, fg_cnt > 0,
                        torch.where(is_hard, hard_cnt > 0, easy_cnt > 0))
    return idx.to(torch.int32), valid


def pdv_loss(cls_logit, reg_deltas, targets, rois, roi_mask, coder=None,
             cls_weight=1.0, reg_weight=1.0, corner_weight=1.0):
    """One sample's RoI loss: BCE of the cls logit against the IoU target
    over the masked RoIs, smooth-L1 of the residuals and the corner loss of
    the decoded boxes over the foreground.  Returns (total, aux dict)."""
    coder = coder or ResidualCoder()
    m = roi_mask.float()
    bce = (torch.clamp(cls_logit, min=0) - cls_logit * targets["cls_target"]
           + torch.log1p(torch.exp(-torch.abs(cls_logit))))
    cls_loss = (bce * m).sum() / torch.clamp(m.sum(), min=1.0)
    fg = targets["fg_mask"].float()
    l1 = weighted_smooth_l1(reg_deltas, targets["reg_target"]).mean(-1)
    reg_loss = (l1 * fg).sum() / torch.clamp(fg.sum(), min=1.0)
    corner = corner_loss_lidar(coder.decode(reg_deltas, rois[:, :7]),
                               targets["matched_gt"],
                               mask=targets["fg_mask"])
    total = cls_weight * cls_loss + reg_weight * reg_loss \
        + corner_weight * corner
    return total, {"roi_cls": cls_loss, "roi_reg": reg_loss,
                   "roi_corner": corner}


def pdv_predict(cls_logit, reg_deltas, rois, first_stage_scores, coder=None):
    """Refined boxes and scores sqrt(sigmoid(cls) * first-stage score)."""
    coder = coder or ResidualCoder()
    boxes = coder.decode(reg_deltas, rois[..., :7])
    scores = torch.sqrt(torch.clamp(
        torch.sigmoid(cls_logit) * first_stage_scores, 1e-8, 1.0))
    return boxes, scores

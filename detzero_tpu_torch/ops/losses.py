"""The center head's losses (port of `focal_loss_centernet` and
`reg_loss_centernet` of `detzero_tpu/ops/losses.py`).  Both reduce over
their trailing axes, so a leading batch axis gives one loss per sample, as
the reference's vmap does.  The head's outputs are float32 (the reference
casts them), so the losses compute in float32."""

from __future__ import annotations

import torch


def focal_loss_centernet(pred_hm, gt_hm, eps: float = 1e-4):
    """CornerNet focal loss of sigmoid-ed heatmaps ([N,] C, H, W), normalised
    by the number of positives (gt == 1 cells) of each sample."""
    dims = (-3, -2, -1)
    pred = torch.clamp(pred_hm, eps, 1.0 - eps)
    pos = (gt_hm >= 1.0).float()
    neg_w = torch.pow(1.0 - gt_hm, 4.0)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2.0) * pos
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, 2.0) * neg_w \
        * (1.0 - pos)
    num_pos = pos.sum(dims)
    loss = -(pos_loss.sum(dims) + neg_loss.sum(dims))
    return torch.where(num_pos > 0, loss / torch.clamp(num_pos, min=1.0),
                       -neg_loss.sum(dims))


def gather_cells(feat, inds):
    """feat ([N,] H, W, C), inds ([N,] M) flat cell indices -> ([N,] M, C)."""
    h, w, c = feat.shape[-3:]
    flat = feat.reshape(*feat.shape[:-3], h * w, c)
    return torch.gather(flat, -2,
                        inds.long()[..., None].expand(*inds.shape, c))


def reg_loss_centernet(pred_map, inds, target, mask, code_weights=None):
    """L1 at the target cells: pred_map ([N,] H, W, C), inds ([N,] M),
    target ([N,] M, C), mask ([N,] M).  Returns the summed loss over the
    valid slots divided by their count, per sample."""
    pred = gather_cells(pred_map, inds)
    diff = torch.abs(pred - target) * mask[..., None].to(pred.dtype)
    if code_weights is not None:
        diff = diff * torch.tensor(code_weights, dtype=pred.dtype,
                                   device=pred.device)
    num = torch.clamp(mask.sum(-1).to(pred.dtype), min=1.0)
    return diff.sum((-2, -1)) / num

"""The detection losses (port of `detzero_tpu/ops/losses.py`): those of
the center head and the PDV RoI head, `gather_feat` and the anchor/RoI
heads' `sigmoid_focal_cls_loss`.  The center head's
two reduce over their trailing axes, so a leading batch axis gives one loss
per sample, as the reference's vmap does.  The heads' outputs are float32
(the reference casts them), so the losses compute in float32."""

from __future__ import annotations

import math

import torch

from detzero_tpu_torch.ops.box_ops import boxes_to_corners_3d


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


def gather_feat(feat_hw_c, inds):
    """feat (H*W, C), inds (M,) -> (M, C): rows of a flattened map (the
    reference's layout; `gather_cells` takes the unflattened, batched
    one)."""
    return feat_hw_c[inds.long()]


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


def weighted_smooth_l1(pred, target, weights=None, beta: float = 1.0 / 9.0):
    """Elementwise smooth-L1 (reference WeightedSmoothL1Loss), times
    `weights` where given: of the loss's shape, or of its leading axes
    (broadcast over the last)."""
    n = torch.abs(pred - target)
    loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    if weights is None:
        return loss
    return loss * (weights[..., None] if loss.ndim == weights.ndim + 1
                   else weights)


def corner_loss_lidar(pred_boxes, gt_boxes, mask=None):
    """Huber (delta 1) of the 8 corner distances, the smaller of the GT box
    and its heading flipped by pi, averaged over corners; over the boxes
    `mask` marks (N, 7)."""
    pred_c = boxes_to_corners_3d(pred_boxes)
    gt_c = boxes_to_corners_3d(gt_boxes)
    flip = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + math.pi], 1)
    gt_cf = boxes_to_corners_3d(flip)
    dist = torch.minimum(torch.linalg.vector_norm(pred_c - gt_c, dim=-1),
                         torch.linalg.vector_norm(pred_c - gt_cf, dim=-1))
    loss = torch.where(dist < 1.0, 0.5 * dist * dist, dist - 0.5).mean(1)
    if mask is None:
        return loss.mean()
    m = mask.to(loss.dtype)
    return (loss * m).sum() / torch.clamp(m.sum(), min=1.0)


def sigmoid_focal_cls_loss(pred_logits, target, weights, gamma: float = 2.0,
                           alpha: float = 0.25):
    """Elementwise sigmoid focal loss of the anchor/RoI heads, times
    `weights` (of the loss's shape, or of its leading axes)."""
    p = torch.clamp(1.0 / (1.0 + torch.exp(-pred_logits)), 1e-6, 1 - 1e-6)
    alpha_w = target * alpha + (1 - target) * (1 - alpha)
    pt = target * (1.0 - p) + (1.0 - target) * p
    bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    loss = alpha_w * torch.pow(pt, gamma) * bce
    return loss * (weights[..., None] if loss.ndim == weights.ndim + 1
                   else weights)

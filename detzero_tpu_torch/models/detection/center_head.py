"""Center head (port of the reference's center_head.py): per-head conv
stacks; gaussian-heatmap targets and the focal + L1 + IoU-branch loss of
training; and the static-shape decode of inference (top-k over the
iou-rectified heatmap, box decode and rotated NMS)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from detzero_tpu_torch.models.layers import Conv2dSame, ConvBNReLU
from detzero_tpu_torch.ops import gaussian
from detzero_tpu_torch.ops.iou3d import boxes_iou3d_pairwise
from detzero_tpu_torch.ops.losses import (
    focal_loss_centernet, gather_cells, reg_loss_centernet,
)
from detzero_tpu_torch.ops.nms import nms_bev, topk_stable

HEAD_ORDER = ("center", "center_z", "dim", "rot", "vel")
HEAD_DIMS = {"center": 2, "center_z": 1, "dim": 3, "rot": 2, "vel": 2}
HM_BIAS = -2.19     # initial heatmap bias (CenterPoint.init_parameters)


class SeparateHead(nn.Module):
    """Per-task conv stacks on NCHW maps; outputs are float32 (N, H, W, C)
    maps."""

    def __init__(self, cin, heads: dict, num_conv=2, mid_channels=64,
                 device=None):
        super().__init__()
        self.heads = dict(heads)
        self.num_conv = num_conv
        for name, ch in self.heads.items():
            c = cin
            for i in range(num_conv - 1):
                self.add_module(f"{name}_conv{i}", ConvBNReLU(
                    c, mid_channels, 3, 1, device=device))
                c = mid_channels
            self.add_module(f"{name}_out", Conv2dSame(c, ch, 3, bias=True,
                                                      device=device))

    def forward(self, x):
        out = {}
        for name in self.heads:
            h = x
            for i in range(self.num_conv - 1):
                h = getattr(self, f"{name}_conv{i}")(h)
            out[name] = getattr(self, f"{name}_out")(h).permute(
                0, 2, 3, 1).float()
        return out


class CenterHead(nn.Module):
    """Multi-group center head; class_ids_each_head holds each head's global
    class ids."""

    def __init__(self, cin, class_ids_each_head: Sequence[Sequence[int]],
                 shared_channels=64, num_conv=2, with_velocity=True,
                 with_iou=True, device=None):
        super().__init__()
        self.shared_conv = ConvBNReLU(cin, shared_channels, 3, 1,
                                      device=device)
        self.n_heads = len(class_ids_each_head)
        for hi, cls_ids in enumerate(class_ids_each_head):
            heads = {"hm": len(cls_ids)}
            for name in HEAD_ORDER:
                if name == "vel" and not with_velocity:
                    continue
                heads[name] = HEAD_DIMS[name]
            if with_iou:
                heads["iou"] = 1
            self.add_module(f"head{hi}", SeparateHead(
                shared_channels, heads, num_conv, shared_channels,
                device=device))

    def forward(self, x_hwc):
        """([N,] H, W, C) -> list of per-head dicts of ([N,] H, W, ch)
        float32."""
        if x_hwc.ndim == 3:
            return [{k: v[0] for k, v in h.items()}
                    for h in self.forward(x_hwc[None])]
        x = self.shared_conv(x_hwc.movedim(-1, 1))
        return [getattr(self, f"head{hi}")(x) for hi in range(self.n_heads)]


def assign_targets(gt_boxes, gt_classes, gt_valid, class_ids_each_head, hw,
                   feature_map_stride, voxel_size, pc_range, max_objs,
                   gaussian_overlap=0.1, min_radius=2, with_velocity=True):
    """Per-head target dicts of a batch: gt_boxes (N, M, 7|9), gt_classes
    (N, M) global class ids, gt_valid (N, M).  Each head maps its classes
    to local indices and masks out the rest; every entry gains a leading
    batch axis."""
    targets = []
    for cls_ids in class_ids_each_head:
        ids = torch.tensor(cls_ids, dtype=gt_classes.dtype,
                           device=gt_classes.device)
        hit = gt_classes[..., None] == ids
        local = torch.argmax(hit.to(torch.int32), -1).to(torch.int32)
        per = [gaussian.assign_center_targets(
            gt_boxes[b], local[b], gt_valid[b] & hit[b].any(-1), len(cls_ids),
            hw, feature_map_stride, voxel_size, pc_range, max_objs,
            min_radius=min_radius, gaussian_overlap=gaussian_overlap,
            with_velocity=with_velocity) for b in range(gt_boxes.shape[0])]
        targets.append({k: torch.stack([t[k] for t in per]) for k in per[0]})
    return targets


def _decode_at_inds(pred, inds, hw, feature_map_stride, voxel_size,
                    pc_range):
    """Decode boxes at flat cell indices: maps ([N,] H, W, C), inds
    ([N,] M) -> ([N,] M, 7[+2])."""
    h, w = hw
    xs = (inds % w).float()
    ys = torch.div(inds, w, rounding_mode="floor").float()

    def flat(name):
        return gather_cells(pred[name], inds)

    center = flat("center")
    cx = (xs + center[..., 0]) * feature_map_stride * voxel_size[0] \
        + pc_range[0]
    cy = (ys + center[..., 1]) * feature_map_stride * voxel_size[1] \
        + pc_range[1]
    dim = torch.exp(torch.clamp(flat("dim"), -5.0, 5.0))
    rot = flat("rot")
    heading = torch.atan2(rot[..., 0], rot[..., 1])
    cols = [cx[..., None], cy[..., None], flat("center_z")[..., :1], dim,
            heading[..., None]]
    if "vel" in pred:
        cols.append(flat("vel"))
    return torch.cat(cols, -1)


def iou_pairs(pred, tgt, hw, feature_map_stride, voxel_size, pc_range):
    """The matched box pairs of the IoU branch for one head: the box decoded
    at each target cell (detached) and its target box, both ([N,] M, 7)."""
    inds = tgt["inds"].long()
    boxes = _decode_at_inds(pred, inds, hw, feature_map_stride, voxel_size,
                            pc_range)[..., :7].detach()
    anno = tgt["anno_box"]
    xs = (inds % hw[1]).float()
    ys = torch.div(inds, hw[1], rounding_mode="floor").float()
    gx = (xs + anno[..., 0]) * feature_map_stride * voxel_size[0] \
        + pc_range[0]
    gy = (ys + anno[..., 1]) * feature_map_stride * voxel_size[1] \
        + pc_range[1]
    gt_boxes = torch.stack(
        [gx, gy, anno[..., 2], torch.exp(anno[..., 3]),
         torch.exp(anno[..., 4]), torch.exp(anno[..., 5]),
         torch.atan2(anno[..., 6], anno[..., 7])], -1)
    return boxes, gt_boxes


def center_head_loss(preds, targets, hw, feature_map_stride, voxel_size,
                     pc_range, code_weights=None, hm_weight=1.0,
                     loc_weight=2.0, iou_weight=1.0):
    """Per-sample loss over all heads: focal(hm) + 2 * L1(regression at the
    target cells) + L1(iou prediction vs the 3D IoU of the decoded box and
    its target box, mapped to [-1, 1]).  preds and targets are per-head
    dicts with a leading batch axis N.  Returns (loss (N,), aux dict of
    (N,)).  The IoU of every sample's matched pairs is one launch of
    kernel K6 per head."""
    total, aux = 0.0, {}
    for hi, (pred, tgt) in enumerate(zip(preds, targets)):
        hm_loss = focal_loss_centernet(
            torch.sigmoid(pred["hm"]).movedim(-1, -3), tgt["heatmap"])
        reg_map = torch.cat([pred[n] for n in HEAD_ORDER if n in pred], -1)
        n_code = reg_map.shape[-1]
        cw = code_weights if code_weights is not None else [1.0] * n_code
        loc_loss = reg_loss_centernet(reg_map, tgt["inds"],
                                      tgt["anno_box"][..., :n_code],
                                      tgt["mask"], code_weights=cw[:n_code])
        head_loss = hm_weight * hm_loss + loc_weight * loc_loss
        if "iou" in pred:
            inds = tgt["inds"].long()
            boxes, gt_boxes = iou_pairs(pred, tgt, hw, feature_map_stride,
                                        voxel_size, pc_range)
            iou_tgt = boxes_iou3d_pairwise(
                boxes.reshape(-1, 7), gt_boxes.reshape(-1, 7)).reshape(
                inds.shape)
            iou_tgt = iou_tgt * 2.0 - 1.0
            iou_pred = gather_cells(pred["iou"], inds)[..., 0]
            m = tgt["mask"].float()
            iou_loss = (torch.abs(iou_pred - iou_tgt) * m).sum(-1) \
                / torch.clamp(m.sum(-1), min=1.0)
            head_loss = head_loss + iou_weight * iou_loss
            aux[f"head{hi}/iou_loss"] = iou_loss
        aux[f"head{hi}/hm_loss"] = hm_loss
        aux[f"head{hi}/loc_loss"] = loc_loss
        total = total + head_loss
    return total, aux


def decode_predictions(preds, class_ids_each_head, hw, feature_map_stride,
                       voxel_size, pc_range, top_k=500, score_thresh=0.1,
                       nms_thresh=0.7, nms_pre=1024, nms_post=256,
                       iou_rectify_alpha=2.0):
    """Static-shape decode across all heads -> dict(boxes (P, 9), scores
    (P,), labels (P,) int32, mask (P,)) with P = nms_post.  Scores are
    iou^alpha-rectified before NMS."""
    all_boxes, all_scores, all_labels = [], [], []
    h, w = hw
    for pred, cls_ids in zip(preds, class_ids_each_head):
        hm = torch.sigmoid(pred["hm"]).reshape(h * w, -1)
        if "iou" in pred:
            iou = torch.clamp((pred["iou"].reshape(h * w) + 1.0) * 0.5,
                              0.0, 1.0)
            hm = hm * torch.pow(iou[:, None], iou_rectify_alpha)
        flat = hm.reshape(-1)
        scores, flat_idx = topk_stable(flat, min(top_k, flat.shape[0]))
        n_cls = hm.shape[1]
        boxes = _decode_at_inds(pred, torch.div(flat_idx, n_cls,
                                                rounding_mode="floor"),
                                hw, feature_map_stride, voxel_size, pc_range)
        ids = torch.tensor(cls_ids, dtype=torch.int32, device=hm.device)
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_labels.append(ids[flat_idx % n_cls])
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)
    labels = torch.cat(all_labels)
    keep_idx, keep_mask = nms_bev(
        boxes[:, :7], scores, nms_thresh, pre_max=min(nms_pre, boxes.shape[0]),
        post_max=nms_post, valid_mask=scores > score_thresh)
    keep_idx = keep_idx.long()
    return {"boxes": boxes[keep_idx], "scores": scores[keep_idx],
            "labels": labels[keep_idx], "mask": keep_mask}

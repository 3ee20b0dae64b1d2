"""Center head and static-shape decode (port of the inference half of the
reference's center_head.py): per-head conv stacks, top-k over the
iou-rectified heatmap, box decode and rotated NMS."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from detzero_tpu_torch.models.layers import Conv2dSame, ConvBNReLU
from detzero_tpu_torch.ops.nms import nms_bev, topk_stable

HEAD_ORDER = ("center", "center_z", "dim", "rot", "vel")
HEAD_DIMS = {"center": 2, "center_z": 1, "dim": 3, "rot": 2, "vel": 2}
HM_BIAS = -2.19     # initial heatmap bias (CenterPoint.init_parameters)


class SeparateHead(nn.Module):
    """Per-task conv stacks; outputs are float32 (H, W, C) maps."""

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
            out[name] = getattr(self, f"{name}_out")(h)[0].permute(
                1, 2, 0).float()
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
        """(H, W, C) -> list of per-head dicts of (H, W, ch) float32."""
        x = self.shared_conv(x_hwc.permute(2, 0, 1)[None])
        return [getattr(self, f"head{hi}")(x) for hi in range(self.n_heads)]


def _decode_at_inds(pred, inds, hw, feature_map_stride, voxel_size,
                    pc_range):
    """Decode boxes at flat cell indices -> (M, 7[+2])."""
    h, w = hw
    xs = (inds % w).float()
    ys = torch.div(inds, w, rounding_mode="floor").float()

    def flat(name):
        return pred[name].reshape(h * w, -1)[inds]

    center = flat("center")
    cx = (xs + center[:, 0]) * feature_map_stride * voxel_size[0] \
        + pc_range[0]
    cy = (ys + center[:, 1]) * feature_map_stride * voxel_size[1] \
        + pc_range[1]
    dim = torch.exp(torch.clamp(flat("dim"), -5.0, 5.0))
    rot = flat("rot")
    heading = torch.atan2(rot[:, 0], rot[:, 1])
    cols = [cx[:, None], cy[:, None], flat("center_z")[:, :1], dim,
            heading[:, None]]
    if "vel" in pred:
        cols.append(flat("vel"))
    return torch.cat(cols, 1)


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

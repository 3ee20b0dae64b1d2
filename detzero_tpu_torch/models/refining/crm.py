"""CRM, the Confidence Refining Model (port of
detzero_tpu/models/refining/crm.py): a two-level PointNet over a padded
track.  Each box's points pool into a box feature, the valid boxes pool
into a track feature (a track with no valid box pools to 0), the two are
concatenated a box and fed to the `score` and `iou` heads; the confidence
is sqrt(sigmoid(score) * sigmoid(iou)).  A leading batch axis where the
reference vmaps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from detzero_tpu_torch.core.registry import REFINE_MODULES
from detzero_tpu_torch.models.layers import Linear
from detzero_tpu_torch.models.refining.modules import (
    PointNetEncoder, init_flax_like, resolve_device,
)
from detzero_tpu_torch.models.refining.target_assign import (
    confidence_labels,
)


@REFINE_MODULES.register("ConfidencePointNet")
class ConfidencePointNet(nn.Module):
    """forward(box_pts (B, T, Np, F), pad_mask (B, T)) -> {score_logit
    (B, T), iou_logit (B, T)}.  `iou_band` (lo, hi), the class's
    IOU_BANDS, is what `loss` labels against."""

    def __init__(self, d_model: int = 256, num_features: int = 32,
                 iou_band=(0.35, 0.7), device=None):
        super().__init__()
        device = resolve_device(device)
        self.iou_band = tuple(float(v) for v in iou_band)
        self.box_enc = PointNetEncoder(num_features, (64, 128, d_model),
                                       device=device)
        cin = 2 * d_model
        for i, f in enumerate((256, 128)):
            self.add_module(f"head{i}", Linear(cin, f, device=device))
            cin = f
        self.score = Linear(cin, 1, device=device)
        self.iou = Linear(cin, 1, device=device)

    def init_parameters(self, generator: torch.Generator):
        return init_flax_like(self, generator)

    def forward(self, box_pts, pad_mask):
        box_feat = self.box_enc(box_pts)                      # (B, T, D)
        masked = torch.where(pad_mask[..., None], box_feat, -math.inf)
        track = masked.max(1).values
        track = torch.where(torch.isfinite(track), track, 0.0)
        h = torch.cat([box_feat, track[:, None].expand_as(box_feat)], -1)
        h = F.relu(self.head1(F.relu(self.head0(h))))
        return {"score_logit": self.score(h)[..., 0],
                "iou_logit": self.iou(h)[..., 0]}

    def loss(self, query_pts, pad_mask, gt_ious, generator=None, **_):
        """The batch's loss (tools/train_refine.py's reduction): the
        class's IOU_BANDS, then the mean.  Returns (loss, per-sample
        aux)."""
        pred = self(query_pts, pad_mask)
        losses, aux = crm_loss(pred, gt_ious, pad_mask, *self.iou_band)
        return losses.mean(), aux


def sigmoid_ce(logits, labels):
    """Numerically stable sigmoid cross entropy (optax's)."""
    return torch.clamp(logits, min=0.0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def crm_loss(pred, gt_ious, pad_mask, iou_lo=0.35, iou_hi=0.7):
    """Per sample: BCE of the score head on the pos/neg labels (the band
    between ignored) and of the iou head on the clipped IoU as a soft
    target.  gt_ious (B, T), -1 for no label.  Returns ((B,) losses,
    aux)."""
    labels, w = confidence_labels(gt_ious, iou_lo, iou_hi)
    w = w * pad_mask.to(torch.float32)
    score = (sigmoid_ce(pred["score_logit"], labels) * w).sum(-1) \
        / torch.clamp(w.sum(-1), min=1.0)
    m = pad_mask.to(torch.float32) * (gt_ious >= 0.0)
    iou = (sigmoid_ce(pred["iou_logit"], torch.clamp(gt_ious, 0.0, 1.0))
           * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    return score + iou, {"crm_score": score, "crm_iou": iou}


def crm_decode(pred):
    """The confidence (B, T): sqrt(clip(sigmoid(s) * sigmoid(i), 1e-8,
    1))."""
    s = torch.sigmoid(pred["score_logit"])
    i = torch.sigmoid(pred["iou_logit"])
    return torch.sqrt(torch.clamp(s * i, 1e-8, 1.0))

"""PRM, the Position Refining Model (port of
detzero_tpu/models/refining/prm.py): whole-track center and heading
smoothing.  Each of the track's (at most T) boxes is a query token (a
PointNet over its init-frame points) with a learned (x, y, z, yaw)
positional embedding; the memory is every box's point set (T x Nm
tokens).  The decoder self-attends across the track and cross-attends to
the memory, both with padding masks (a padded query's rows are fully
masked: uniform weights, as flax gives them).  Heads: a center residual,
a 12-bin heading class and its in-bin residual.  A leading batch axis
where the reference vmaps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from detzero_tpu_torch.core.registry import REFINE_MODULES
from detzero_tpu_torch.models.layers import LayerNorm, Linear
from detzero_tpu_torch.models.refining.modules import (
    DecoderLayer, PointNetEncoder, PositionEmbeddingLearned, init_flax_like,
    resolve_device,
)
from detzero_tpu_torch.models.refining.target_assign import (
    NUM_HEADING_BINS, decode_heading, encode_heading,
)


@REFINE_MODULES.register("PositionTransformer")
class PositionTransformer(nn.Module):
    """forward(query_pts (B, T, Np, F), query_boxes (B, T, 4) [x, y, z,
    yaw] in init-box coords, memory_pts (B, T, Nm, F), pad_mask (B, T))
    -> {center (B, L, T, 3), heading_logits (B, L, T, 12), heading_res
    (B, L, T, 12)}.  `mem_points` is the reference's constructor field;
    the memory's size comes from the input."""

    def __init__(self, d_model: int = 256, n_heads: int = 4,
                 num_decoder_layers: int = 1, mem_points: int = 48,
                 num_features: int = 32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.mem_points = mem_points
        self.num_decoder_layers = num_decoder_layers
        self.query_enc = PointNetEncoder(num_features, (64, 128, d_model),
                                         device=device)
        self.query_pos = PositionEmbeddingLearned(4, d_model, device=device)
        cin = num_features
        for i, f in enumerate((64, d_model)):
            self.add_module(f"mem{i}", Linear(cin, f, device=device))
            self.add_module(f"mem_ln{i}", LayerNorm(f, device=device))
            cin = f
        self.mem_pos = PositionEmbeddingLearned(3, d_model, device=device)
        for li in range(num_decoder_layers):
            self.add_module(f"dec{li}", DecoderLayer(d_model, n_heads,
                                                     device=device))
            self.add_module(f"out_mlp{li}", Linear(d_model, d_model,
                                                   device=device))
            self.add_module(f"center{li}", Linear(d_model, 3, device=device))
            self.add_module(f"hbin{li}", Linear(d_model, NUM_HEADING_BINS,
                                                device=device))
            self.add_module(f"hres{li}", Linear(d_model, NUM_HEADING_BINS,
                                                device=device))

    def init_parameters(self, generator: torch.Generator):
        return init_flax_like(self, generator)

    def forward(self, query_pts, query_boxes, memory_pts, pad_mask):
        b, t = query_pts.shape[:2]
        q_tok = self.query_enc(query_pts)
        q_pos = self.query_pos(query_boxes)
        m = memory_pts.float()
        for i in range(2):
            m = F.relu(getattr(self, f"mem_ln{i}")(
                getattr(self, f"mem{i}")(m)))
        nm = m.shape[2]
        mem = m.reshape(b, t * nm, self.d_model)
        mem_mask = pad_mask.repeat_interleave(nm, dim=1)
        m_pos = self.mem_pos(memory_pts[..., :3].reshape(b, t * nm, 3))
        outs = {"center": [], "heading_logits": [], "heading_res": []}
        x = q_tok
        for li in range(self.num_decoder_layers):
            x = getattr(self, f"dec{li}")(
                x, mem, query_pos=q_pos, memory_pos=m_pos,
                query_mask=pad_mask, memory_mask=mem_mask)
            h = F.relu(getattr(self, f"out_mlp{li}")(x))
            outs["center"].append(getattr(self, f"center{li}")(h))
            outs["heading_logits"].append(getattr(self, f"hbin{li}")(h))
            outs["heading_res"].append(getattr(self, f"hres{li}")(h))
        return {k: torch.stack(v, 1) for k, v in outs.items()}

    def loss(self, query_pts, query_boxes, memory_pts, pad_mask, gt_centers,
             gt_headings, gt_mask, generator=None, **_):
        """The batch's loss (tools/train_refine.py's reduction): the mask
        is pad_mask & gt_mask, then the mean over the batch.  Returns
        (loss, per-sample aux)."""
        pred = self(query_pts, query_boxes, memory_pts, pad_mask)
        losses, aux = prm_loss(pred, gt_centers, gt_headings,
                               pad_mask & gt_mask)
        return losses.mean(), aux


def prm_loss(pred, gt_centers, gt_headings, pad_mask, center_weight=1.0,
             cls_weight=0.1, res_weight=2.0):
    """Per sample: masked L1 of the center, cross entropy of the heading
    bin and L1 of the gathered in-bin residual, each over the valid boxes
    and the layers.  gt (B, T, 3) / (B, T).  Returns ((B,) losses, aux)."""
    m = pad_mask.to(torch.float32)
    denom = torch.clamp(m.sum(1), min=1.0)
    n_layers = pred["center"].shape[1]
    mm = m[:, None]
    center_l1 = ((pred["center"] - gt_centers[:, None]).abs().mean(-1)
                 * mm).sum((1, 2)) / (denom * n_layers)
    b_t, r_t = encode_heading(gt_headings)
    logp = F.log_softmax(pred["heading_logits"], -1)          # (B, L, T, 12)
    idx = b_t.long()[:, None, :, None].expand(*logp.shape[:-1], 1)
    ce = -(torch.gather(logp, -1, idx)[..., 0] * mm).sum((1, 2)) \
        / (denom * n_layers)
    res_p = torch.gather(pred["heading_res"], -1, idx)[..., 0]
    res_l1 = ((res_p - r_t[:, None]).abs() * mm).sum((1, 2)) \
        / (denom * n_layers)
    total = center_weight * center_l1 + cls_weight * ce + res_weight * res_l1
    return total, {"prm_center": center_l1, "prm_hce": ce,
                   "prm_hres": res_l1}


def prm_decode(pred, query_boxes=None):
    """The last layer's center (B, T, 3) and heading (B, T).  The center is
    a residual: query_boxes (B, T, 4) supply the centers added back
    (without them the raw residuals come out).  The heading is absolute
    in init coords."""
    center = pred["center"][:, -1]
    heading = decode_heading(pred["heading_logits"][:, -1],
                             pred["heading_res"][:, -1])
    if query_boxes is not None:
        center = center + query_boxes[..., :3]
    return center, heading

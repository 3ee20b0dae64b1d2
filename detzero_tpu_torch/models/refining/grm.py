"""GRM, the Geometry Refining Model (port of
detzero_tpu/models/refining/grm.py): per-track size refinement.  The top-Q
proposals by score become query tokens (a PointNet over each one's
box-local points) with their sizes as the positional prior; the memory is
the track's registered point cloud; a decoder layer predicts residuals to
the nearest of K size anchors and the anchor's class.  Decode averages the
size over layers and queries.  The reference runs one object a call under
vmap; here every tensor has a leading batch axis.
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
    DEFAULT_SIZE_ANCHORS, decode_size, encode_size,
)


@REFINE_MODULES.register("GeometryTransformer")
class GeometryTransformer(nn.Module):
    """forward(query_pts (B, Q, Np, F), query_sizes (B, Q, 3),
    memory_pts (B, M, F), memory_mask (B, M)) -> {anchor_logits
    (B, L, Q, K), size_res (B, L, Q, K, 3)}.  `anchors` (K, 3), the
    class's size anchors, are what `loss` encodes the GT size against."""

    def __init__(self, d_model: int = 256, n_heads: int = 4,
                 num_anchors: int = 3, num_decoder_layers: int = 1,
                 num_features: int = 11, anchors=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_anchors = num_anchors
        self.num_decoder_layers = num_decoder_layers
        if anchors is None:
            anchors = DEFAULT_SIZE_ANCHORS["Vehicle"]
        self.register_buffer("anchors", torch.as_tensor(
            anchors, dtype=torch.float32, device=device), persistent=False)
        self.query_enc = PointNetEncoder(num_features, (64, 128, d_model),
                                         device=device)
        self.query_pos = PositionEmbeddingLearned(3, d_model, device=device)
        cin = num_features
        for i, f in enumerate((64, 128, d_model)):
            self.add_module(f"mem{i}", Linear(cin, f, device=device))
            self.add_module(f"mem_ln{i}", LayerNorm(f, device=device))
            cin = f
        self.mem_pos = PositionEmbeddingLearned(3, d_model, device=device)
        for li in range(num_decoder_layers):
            self.add_module(f"dec{li}", DecoderLayer(d_model, n_heads,
                                                     device=device))
            self.add_module(f"out_mlp{li}", Linear(d_model, d_model,
                                                   device=device))
            self.add_module(f"cls{li}", Linear(d_model, num_anchors,
                                               device=device))
            self.add_module(f"reg{li}", Linear(d_model, num_anchors * 3,
                                               device=device))

    def init_parameters(self, generator: torch.Generator):
        return init_flax_like(self, generator)

    def forward(self, query_pts, query_sizes, memory_pts, memory_mask):
        q_tok = self.query_enc(query_pts)
        q_pos = self.query_pos(query_sizes)
        m = memory_pts.float()
        for i in range(3):
            m = F.relu(getattr(self, f"mem_ln{i}")(
                getattr(self, f"mem{i}")(m)))
        m_pos = self.mem_pos(memory_pts[..., :3])
        logits, res = [], []
        x = q_tok
        for li in range(self.num_decoder_layers):
            x = getattr(self, f"dec{li}")(
                x, m, query_pos=q_pos, memory_pos=m_pos,
                memory_mask=memory_mask)
            h = F.relu(getattr(self, f"out_mlp{li}")(x))
            logits.append(getattr(self, f"cls{li}")(h))
            res.append(getattr(self, f"reg{li}")(h).reshape(
                *h.shape[:-1], self.num_anchors, 3))
        return {"anchor_logits": torch.stack(logits, 1),
                "size_res": torch.stack(res, 1)}

    def loss(self, query_pts, query_sizes, memory_pts, memory_mask, gt_size,
             has_gt, generator=None, **_):
        """The batch's loss (tools/train_refine.py's reduction): the
        per-sample losses weighted by has_gt over max(sum, 1).  Returns
        (loss, per-sample aux)."""
        pred = self(query_pts, query_sizes, memory_pts, memory_mask)
        losses, aux = grm_loss(pred, gt_size, self.anchors)
        w = has_gt.to(losses.dtype)
        return (losses * w).sum() / torch.clamp(w.sum(), min=1.0), aux


def grm_loss(pred, gt_size, anchors, cls_weight=0.1, reg_weight=2.0):
    """Per sample: the anchor's cross entropy and the L1 of its residual,
    averaged over layers and queries.  gt_size (B, 3).  Returns
    ((B,) losses, {grm_ce, grm_l1} (B,))."""
    cls_t, res_t = encode_size(gt_size, anchors)          # (B,), (B, K, 3)
    logits = pred["anchor_logits"]                        # (B, L, Q, K)
    b, l, q, _ = logits.shape
    idx = cls_t[:, None, None, None].expand(b, l, q, 1)
    ce = -torch.gather(F.log_softmax(logits, -1), -1, idx)[..., 0] \
        .mean((1, 2))
    res_p = torch.gather(pred["size_res"], -2,
                         idx[..., None].expand(b, l, q, 1, 3))[..., 0, :]
    target = res_t[torch.arange(b, device=res_t.device), cls_t]
    l1 = (res_p - target[:, None, None, :]).abs().mean((1, 2, 3))
    return cls_weight * ce + reg_weight * l1, {"grm_ce": ce, "grm_l1": l1}


def grm_decode(pred, anchors):
    """(B, 3) sizes: each sample's decoded size averaged over layers and
    queries.  anchors (K, 3), or one set a sample (B, K, 3)."""
    a = torch.as_tensor(anchors, dtype=torch.float32,
                        device=pred["anchor_logits"].device)
    if a.ndim == 3:
        a = a[:, None, None]
    sizes = decode_size(pred["anchor_logits"], pred["size_res"], a)
    return sizes.reshape(sizes.shape[0], -1, 3).mean(1)

"""Rotated NMS with a static output size (port of `detzero_tpu/ops/nms.py`).

The IoU matrix comes from kernel K3 (`ops/iou_bev.py`) and the greedy walk
from the NMS walk kernel (`csrc/nms_walk.cu`): one block walks the
score-sorted boxes in order, so the walk costs one launch instead of k
dependent ones.  It replaces the walk of
`detzero_tpu/ops/pallas_iou.py::nms_keep_mask` with the semantics of
`nms._greedy_suppress`.  What bounds it on the H100 is latency (k block-wide
barriers).

`nms_walk` launches the kernel for CUDA tensors and takes the plain version
for CPU tensors.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from detzero_tpu_torch import _build
from detzero_tpu_torch.ops.box_ops import boxes3d_to_bev
from detzero_tpu_torch.ops.iou_bev import boxes_iou_bev

LAUNCHES = 0


def nms_walk_plain(iou, valid, thresh: float):
    """iou (K, K) over score-sorted boxes, valid (K,) -> keep mask (K,)."""
    k = iou.shape[0]
    idx = torch.arange(k, device=iou.device)
    suppressed = torch.zeros(k, dtype=torch.bool, device=iou.device)
    for i in range(k):
        keep_i = valid[i] & ~suppressed[i]
        suppressed |= keep_i & (iou[i] > thresh) & (idx > i)
    return valid & ~suppressed


def nms_walk(iou, valid, thresh: float):
    """The walk kernel on CUDA tensors, its plain version on CPU tensors."""
    if iou.device.type == "cpu":
        return nms_walk_plain(iou, valid, thresh)
    k = iou.shape[0]
    if iou.shape != (k, k) or valid.shape != (k,):
        raise ValueError(f"nms_walk: iou {tuple(iou.shape)}, valid "
                         f"{tuple(valid.shape)}")
    iou = iou.float().contiguous()
    valid8 = valid.to(torch.uint8).contiguous()
    _build.require_cuda("nms_walk", iou, valid8)
    keep = torch.empty(k, dtype=torch.uint8, device=iou.device)
    rc = _build.lib().dz_nms_walk(iou.data_ptr(), valid8.data_ptr(),
                                  keep.data_ptr(), k, float(thresh),
                                  _build.stream_ptr(iou.device))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(rc, "dz_nms_walk")
    return keep.bool()


def topk_stable(x, k):
    """Top k, ties broken by lower index first as `jax.lax.top_k` does."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def nms_bev(boxes, scores, thresh: float, pre_max: int = 512,
            post_max: int = 128, valid_mask=None):
    """Class-agnostic rotated NMS.  boxes (N, 7), scores (N,).  Returns
    (indices (post_max,) int32 into the input, keep_mask (post_max,))."""
    n = boxes.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=boxes.device)
    k = min(pre_max, n)
    masked = torch.where(valid_mask, scores,
                         torch.full_like(scores, float("-inf")))
    top_scores, order = topk_stable(masked, k)
    bev = boxes3d_to_bev(boxes[order])
    keep = nms_walk(boxes_iou_bev(bev, bev), torch.isfinite(top_scores),
                    thresh)
    # stable-compact the kept entries to the front (already score-sorted)
    ar = torch.arange(k, device=boxes.device)
    compact = torch.argsort(torch.where(keep, ar, k), stable=True)
    out_idx = order[compact].to(torch.int32)
    if k < post_max:
        out_idx = torch.cat([out_idx, out_idx.new_zeros(post_max - k)])
    out_idx = out_idx[:post_max]
    n_keep = torch.clamp(keep.sum(), max=post_max)
    out_mask = torch.arange(post_max, device=boxes.device) < n_keep
    return out_idx, out_mask

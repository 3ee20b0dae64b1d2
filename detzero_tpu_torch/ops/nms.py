"""Rotated NMS with a static output size (port of `detzero_tpu/ops/nms.py`).

Kernel K10 replaces `detzero_tpu/ops/pallas_iou.py::nms_keep_mask`
(`_launch_nms`: the IoU tiles and the greedy walk in one program) with the
semantics of `nms._greedy_suppress`.  On the card it is three kernels on
one stream, one `nms_keep_mask` call:

  * the boxes' records (corners, areas, edges) and the suppression mask,
    the mask epilogue of K3's tile kernel (`csrc/iou_bev.cu`): words
    (k, ceil(k / 64)) uint64 (int64 here), bit j % 64 of word (i, j / 64)
    set where IoU(i, j) > thresh and j > i, only the tiles on or above the
    diagonal clipped;
  * the walk (`csrc/nms_walk.cu`): one warp, 64 boxes at a time, the next
    64 rows staged into shared memory while the current ones resolve.

`nms_walk` keeps the float-matrix interface: on the card it packs the
matrix into the same words with torch ops (`nms_mask_plain`) and runs the
walk kernel on them.  Each wrapper launches its kernels for CUDA tensors
and takes its plain version for CPU tensors.  `LAUNCHES` counts one a
call of every wrapper that launches K10's kernels: `nms_keep_mask` (the
path's, all three), `nms_walk`, and K10's two halves called alone,
`nms_mask` and `nms_walk_bits`.
"""

from __future__ import annotations

import torch

from detzero_tpu_torch import _build
from detzero_tpu_torch.ops.box_ops import boxes3d_to_bev
from detzero_tpu_torch.ops.iou_bev import _REC_ROWS, boxes_iou_bev_plain

LAUNCHES = 0

_WORD = 64


def mask_words(k: int) -> int:
    """Words of one row of the suppression mask of k boxes."""
    return (k + _WORD - 1) // _WORD


def nms_walk_plain(iou, valid, thresh: float):
    """iou (K, K) over score-sorted boxes, valid (K,) -> keep mask (K,)."""
    k = iou.shape[0]
    idx = torch.arange(k, device=iou.device)
    suppressed = torch.zeros(k, dtype=torch.bool, device=iou.device)
    for i in range(k):
        keep_i = valid[i] & ~suppressed[i]
        suppressed |= keep_i & (iou[i] > thresh) & (idx > i)
    return valid & ~suppressed


def nms_mask_plain(iou, thresh: float):
    """iou (K, K) -> the suppression mask, int64 words (K, ceil(K / 64)):
    bit j % 64 of word (i, j / 64) is iou[i, j] > thresh for j > i; the
    lower triangle and the columns past K are zero."""
    k = iou.shape[0]
    w = mask_words(k)
    idx = torch.arange(k, device=iou.device)
    bits = (iou > thresh) & (idx[None, :] > idx[:, None])
    bits = torch.nn.functional.pad(bits, (0, w * _WORD - k))
    weight = torch.ones(_WORD, dtype=torch.int64, device=iou.device) \
        << torch.arange(_WORD, device=iou.device)
    # distinct powers of two: the sum is the OR (bit 63 wraps to the sign)
    return (bits.reshape(k, w, _WORD).long() * weight).sum(-1)


def _unpack(mask, k):
    """int64 words (K, W) -> bool (K, K)."""
    shift = torch.arange(_WORD, device=mask.device)
    bits = (mask[:, :, None] >> shift) & 1
    return bits.reshape(mask.shape[0], -1)[:, :k].bool()


def nms_walk_bits_plain(mask, valid):
    """The greedy walk over the suppression mask's words (K, W) and valid
    (K,) -> keep mask (K,): box i, kept where it is valid and no kept box
    before it set its bit, suppresses the bits of its row."""
    k = valid.shape[0]
    rows = _unpack(mask, k)
    suppressed = torch.zeros(k, dtype=torch.bool, device=mask.device)
    for i in range(k):
        suppressed |= valid[i] & ~suppressed[i] & rows[i]
    return valid & ~suppressed


def nms_keep_mask_plain(bev, valid, thresh: float):
    """bev (K, 5) score-sorted BEV boxes, valid (K,) -> keep mask (K,)."""
    return nms_walk_plain(boxes_iou_bev_plain(bev, bev), valid, thresh)


def _mask_kernel(bev, thresh):
    k = bev.shape[0]
    words = torch.empty((k, mask_words(k)), dtype=torch.int64,
                        device=bev.device)
    rec = torch.empty(_REC_ROWS * k, dtype=torch.float32, device=bev.device)
    rc = _build.lib().dz_nms_mask(bev.data_ptr(), words.data_ptr(),
                                  rec.data_ptr(), k, float(thresh),
                                  _build.stream_ptr(bev.device))
    _build.check(rc, "dz_nms_mask")
    return words


def _walk_kernel(mask, valid):
    """The walk over the words; valid and keep are torch.bool tensors,
    which the kernel reads and writes as bytes 0/1."""
    k = valid.shape[0]
    keep = torch.empty(k, dtype=torch.bool, device=mask.device)
    rc = _build.lib().dz_nms_walk_bits(mask.data_ptr(), valid.data_ptr(),
                                       keep.data_ptr(), k,
                                       _build.stream_ptr(mask.device))
    _build.check(rc, "dz_nms_walk_bits")
    return keep


def _boxes(bev, name):
    """bev (K, 5+) -> contiguous float32 (K, 5) on the card, or raise."""
    if bev.ndim != 2 or bev.shape[1] < 5:
        raise ValueError(f"{name}: boxes {tuple(bev.shape)}")
    b = bev[:, :5].float().contiguous()
    _build.require_cuda(name, b)
    return b


def _valid(valid, k, name, like):
    """valid (K,) -> contiguous torch.bool on like's card, or raise."""
    if valid.shape != (k,):
        raise ValueError(f"{name}: valid {tuple(valid.shape)} for {k} "
                         f"boxes")
    v = valid.to(torch.bool).contiguous()
    _build.require_cuda(name, like, v)
    return v


def nms_mask(bev, thresh: float):
    """The suppression mask of score-sorted BEV boxes (K, 5): K10's mask
    kernel on CUDA tensors, the plain mask of the plain IoU on CPU."""
    if bev.device.type == "cpu":
        return nms_mask_plain(boxes_iou_bev_plain(bev, bev), thresh)
    b = _boxes(bev, "nms_mask")
    global LAUNCHES
    LAUNCHES += 1
    return _mask_kernel(b, thresh)


def nms_walk_bits(mask, valid):
    """K10's walk over the mask's words on CUDA tensors, its plain version
    on CPU tensors."""
    if mask.device.type == "cpu":
        return nms_walk_bits_plain(mask, valid)
    k = valid.shape[0]
    if mask.shape != (k, mask_words(k)) or mask.dtype != torch.int64:
        raise ValueError(f"nms_walk_bits: mask {tuple(mask.shape)} "
                         f"{mask.dtype} for {k} boxes")
    m = mask.contiguous()
    v = _valid(valid, k, "nms_walk_bits", m)
    global LAUNCHES
    LAUNCHES += 1
    return _walk_kernel(m, v)


def nms_keep_mask(bev, valid, thresh: float):
    """Kernel K10 (boxes, mask, walk) on CUDA tensors, its plain version
    on CPU tensors.  bev (K, 5+) score-sorted, valid (K,) -> keep (K,)."""
    if bev.device.type == "cpu":
        return nms_keep_mask_plain(bev, valid, thresh)
    b = _boxes(bev, "nms_keep_mask")
    v = _valid(valid, b.shape[0], "nms_keep_mask", b)
    if b.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=b.device)
    global LAUNCHES
    LAUNCHES += 1
    return _walk_kernel(_mask_kernel(b, thresh), v)


def nms_walk(iou, valid, thresh: float):
    """K10's walk on a float IoU matrix: on CUDA tensors the matrix packed
    into the mask's words by torch ops, then the walk kernel; the plain
    walk on CPU tensors."""
    if iou.device.type == "cpu":
        return nms_walk_plain(iou, valid, thresh)
    k = iou.shape[0]
    if iou.shape != (k, k):
        raise ValueError(f"nms_walk: iou {tuple(iou.shape)}")
    iou = iou.float().contiguous()
    valid = _valid(valid, k, "nms_walk", iou)
    if k == 0:
        return torch.zeros(0, dtype=torch.bool, device=iou.device)
    global LAUNCHES
    LAUNCHES += 1
    return _walk_kernel(nms_mask_plain(iou, thresh), valid)


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
    keep = nms_keep_mask(bev, torch.isfinite(top_scores), thresh)
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


def multi_class_nms(boxes, scores, labels, num_classes: int, thresh,
                    pre_max: int = 512, post_max: int = 128,
                    valid_mask=None):
    """Per-class rotated NMS: one `nms_bev` a class (one K10 launch each)
    with the other classes' boxes masked invalid.  `thresh` is one float
    or one a class.  Returns [(indices, keep_mask)] a class."""
    outs = []
    for c in range(num_classes):
        t = thresh[c] if hasattr(thresh, "__len__") else thresh
        vm = labels == c
        if valid_mask is not None:
            vm = vm & valid_mask
        outs.append(nms_bev(boxes, scores, t, pre_max, post_max,
                            valid_mask=vm))
    return outs

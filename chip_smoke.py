#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detzero_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and the exit code is 1:
  1. device: versions, card name and power limit (no CUDA -> exit 1);
  2. build: compile detzero_tpu_torch/csrc/*.cu from this checkout;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes of the flagship path, with stated tolerances
     and CUDA-event times (K2 at every distinct conv of the frame, with
     its launches there and the launch-weighted ms a frame); K8 (the plan's
     neighbour-rank maps) on all 10 maps of the flagship plan in its one
     launch, equal on every element to the plain maps and to its
     `torch.searchsorted` yardstick; K3 on 1000 x 1000 clustered boxes and
     on the frame's own NMS input (the decoded top-k boxes), each with the
     walk's keep mask against the plain walk's;
  4. predict: flagship CenterPoint (160k points, 40x1504x1504 grid, bf16,
     random weights from a seeded torch.Generator) on the input of
     __graft_entry__.entry(): launch counts of one frame, frames/s over 5
     timed frames after 2 warm-up frames, per-stage times, peak memory; and
     a tiny-geometry check of the card's outputs against the same model on
     the CPU (plain versions, float32), which the CPU tests hold to the JAX
     reference;
  5. training kernels: K4 (rowpad_conv, 'subm'/'down'/'up') and K5
     (rowpad_conv_dw) against their plain versions at every distinct conv
     of the flagship training step (batch 2), with the launches and the
     launch-weighted ms a step, and K6 (matched-pair IoU) on the
     1000 pairs per head that the next training step forms;
  6. train: the flagship training step at batch 2 through Trainer.step
     (adam_onecycle of configs/det_model_cfgs/centerpoint_5sweeps.yaml):
     launch counts of every step, ms/step over 3 timed steps after one
     warm-up step, per-stage times, peak memory; and the tiny-geometry
     training loss and gradient on the card (float32 and bf16) against the
     CPU's on two draws;
  7. two-stage predict: the flagship with the PDV second stage
     (centerpoint_pdv_5sweeps.yaml: ROI_BUDGET 128, ROI_GRID_SIZE 6,
     ROI_ATTENTION) at batch 1 on the same input: launch counts of one
     frame, frames/s over 5 timed frames after 2 warm-up frames, per-stage
     times with the RoI head's, peak memory;
  8. two-stage training step at batch 2 with 500 GT slots: K7 (the N x M
     rotated overlap of the RoI targets) against its plain version on the
     step's own 128 RoIs x 500 GT boxes and on 1000 x 1000 boxes, then
     launch counts of every step, ms/step over 3 timed steps after one
     warm-up step, per-stage times with the RoI targets and loss, peak
     memory, finite loss and gradient norm;
  9. the tiny two-stage model, card against CPU: predict (first-stage
     heads, multi-scale tables, the RoI head on the CPU's proposals), the
     float32 training loss and its RoI terms, and the RoI head's gradient
     from its own loss on the CPU's proposals;
 10. sliding kernel: K9 (rowpad_conv_sliding) against K4 and against the
     plain version at the flagship training step's
     'subm' shapes (stem, L0, L1, L2, L3);
 11. sliding train: phase 6's step with `rowpad_conv.USE_SLIDING` set for
     this phase only, on fresh weights from the same seed: launch counts
     (K9 for the 17 'subm' forward convs), its warm-up loss against phase
     6's, ms/step over 3 timed steps after the warm-up step, stage times,
     peak memory.
Every counted path also counts K8: one launch a sample (the plan's 10
maps).  Phase 2 prints, for every kernel, ptxas's registers, stack frame
and spills, and fails unless the IoU matrix kernel and the neighbour-map
kernel have neither a stack frame nor spills.
Per-stage times are CUDA events that the model's and the trainer's
`stage_hook` records at their own stage boundaries.  Kernel times are CUDA
events around calls queued behind a spin kernel (`time_ms`), so they read
the card's time even where a wrapper's host cost outlasts its kernel.
The line before the card's line carries every kernel's numbers as JSON:
launches summed over the four counted paths, each path's own in
`launches_by_path`; `bound_ms`, the least time the card could take for the
timed work (the larger of its bytes, each input read once and each output
written once, over 3.35 TB/s, and its operations over the card's peak for
their type, counted from this run's inputs; for the row-pad convs only the
input values of occupied sites that some occupied output reads,
`conv_work`), and `bound_by`; K2, K4 and K5 also carry `weighted_ms`, the
sum over their shapes of kernel ms times launches a frame (K2) or a
training step (K4, K5); `library_ms`:
for K8 its yardstick, `torch.searchsorted` over the target rows plus the
found test; null for the others, since no single PyTorch call computes a
sparse row-pad conv, its weight gradient, a rotated-box overlap, the stream
VFE or the greedy walk.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

FLAGSHIP_CFG = {
    "WITH_VELOCITY": True, "WITH_IOU": True,
    "CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
    "VOXEL_CAPACITIES": (120_000, 60_000, 30_000, 15_000),
    "BACKBONE3D": "pillar_pallas",
}
FLAGSHIP_KW = dict(pc_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                   voxel_size=(0.1, 0.1, 0.15), max_voxels=120_000,
                   max_points=160_000, max_objs=500)
TINY_CFG = {
    "WITH_VELOCITY": True, "WITH_IOU": True,
    "CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
    "VOXEL_CAPACITIES": (512, 256, 128, 64),
    "BACKBONE3D": "pillar_pallas",
}
TINY_KW = dict(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 2.0),
               voxel_size=(0.2, 0.2, 0.5), max_voxels=512, max_points=2048,
               max_objs=8)
# the tiny training check keeps the whole cloud in the pillar budgets, as
# tests/test_torch_train_step.py does
TINY_TRAIN_CFG = dict(TINY_CFG, VOXEL_CAPACITIES=(2048, 1024, 512, 256))
# the PDV second stage: configs/det_model_cfgs/centerpoint_pdv_5sweeps.yaml
# on the flagship, and as tests/test_pdv_head.py sizes it on the tiny one
FLAGSHIP2_CFG = dict(FLAGSHIP_CFG, SECOND_STAGE=True, ROI_BUDGET=128,
                     ROI_GRID_SIZE=6, ROI_ATTENTION=True)
TINY2_CFG = dict(TINY_TRAIN_CFG, SECOND_STAGE=True, ROI_BUDGET=16,
                 ROI_GRID_SIZE=3, ROI_ATTENTION=True)
# OPTIMIZATION of configs/det_model_cfgs/centerpoint_5sweeps.yaml
FLAGSHIP_OPT = {"OPTIMIZER": "adam_onecycle", "LR": 0.003,
                "WEIGHT_DECAY": 0.01, "GRAD_NORM_CLIP": 10.0,
                "PCT_START": 0.4, "DIV_FACTOR": 10}
TRAIN_BATCH = 2          # BATCH_SIZE_PER_DEVICE
GT_SIZES = np.array([[4.5, 2.0, 1.6], [0.9, 0.9, 1.7], [1.8, 0.8, 1.7]],
                    np.float32)

KERNELS = {
    "stream_rowpad_feats": ("detzero_tpu_torch/csrc/stream_vfe.cu",
                            "detzero_tpu/ops/pallas_pillar.py:966"),
    "rowpad_conv_fused": ("detzero_tpu_torch/csrc/rowpad_conv.cu",
                          "detzero_tpu/ops/pallas_pillar.py:638"),
    "boxes_iou_bev": ("detzero_tpu_torch/csrc/iou_bev.cu",
                      "detzero_tpu/ops/pallas_iou.py:186"),
    "nms_walk": ("detzero_tpu_torch/csrc/nms_walk.cu",
                 "detzero_tpu/ops/pallas_iou.py:247"),
    "rowpad_conv": ("detzero_tpu_torch/csrc/rowpad_conv.cu",
                    "detzero_tpu/ops/pallas_pillar.py:577"),
    "rowpad_conv_dw": ("detzero_tpu_torch/csrc/rowpad_conv_dw.cu",
                       "detzero_tpu/ops/pallas_pillar.py:702"),
    "boxes_iou_bev_pairwise": ("detzero_tpu_torch/csrc/iou_bev.cu",
                               "detzero_tpu/ops/pallas_iou.py:208"),
    "boxes_overlap_bev": ("detzero_tpu_torch/csrc/iou_bev.cu",
                          "detzero_tpu/ops/pallas_iou.py:316"),
    "rowpad_nbr": ("detzero_tpu_torch/csrc/rowpad_nbr.cu",
                   "detzero_tpu/ops/pallas_pillar.py:483"),
    "rowpad_conv_sliding": ("detzero_tpu_torch/csrc/rowpad_conv_sliding.cu",
                            "detzero_tpu/ops/pallas_pillar.py:390"),
}
# kernel name -> (module of its wrapper, launch counter)
COUNTERS = {
    "stream_rowpad_feats": ("stream_vfe", "LAUNCHES"),
    "rowpad_conv_fused": ("rowpad_conv", "LAUNCHES"),
    "boxes_iou_bev": ("iou_bev", "LAUNCHES"),
    "nms_walk": ("nms", "LAUNCHES"),
    "rowpad_conv": ("rowpad_conv", "CONV_LAUNCHES"),
    "rowpad_conv_dw": ("rowpad_conv", "DW_LAUNCHES"),
    "boxes_iou_bev_pairwise": ("iou_bev", "PAIRWISE_LAUNCHES"),
    "boxes_overlap_bev": ("iou_bev", "OVERLAP_LAUNCHES"),
    "rowpad_nbr": ("rowpad_nbr", "LAUNCHES"),
    "rowpad_conv_sliding": ("rowpad_conv", "SLIDING_LAUNCHES"),
}
# K8: the 10 neighbour maps of each sample's plan, in one launch
NBR_MAPS = 10
NBR_LAUNCHES = 1
# kernels whose ptxas report must show no stack frame and no spills
NO_STACK_KERNELS = ("iou_bev_matrix_kernel", "rowpad_nbr_maps_kernel")
# H100 SXM (NVIDIA's data sheet): device memory rate and dense peaks; the
# data sheet gives no int32 rate, so K8's int32 compares are counted at the
# CUDA cores' float32 peak
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
# float32 operations of the rotated-box overlap that the data need (a
# compare, abs, sin or cos counts as one), from the body of
# csrc/iou_bev.cu: per box once, the 4 corners (sin, cos, 2 half extents,
# 10 per corner), the area, the 4 edge vectors (8) and the shoelace area of
# its quad (4 x 5 + 2); per pair, the cull's side tests (5 and a compare for
# each of A's 4 corners) at each edge of B it tests; for a pair the cull
# cannot tell, the clip: per edge of B that meets live vertices, nothing
# more (the edge vector is the box's); per live vertex, the side test (5),
# its compare and the crossing test; per crossing, denom, guard (2), t and
# the point (6); per vertex of the final polygon, the shoelace term (4),
# and the abs and the half; with the IoU epilogue, the union and the divide
# (4) per pair.
CLIP_OPS = dict(box=75, edge_test=24, vertex=7, crossing=10, area_vertex=4,
                area=2, iou=4)


def entry_points(n_points=160_000, seed=0, batch=1):
    """__graft_entry__.entry()'s input, rebuilt without jax; sample b > 0
    takes the next draws of the same RandomState."""
    rng = np.random.RandomState(seed)
    pts = np.empty((batch, n_points, 5), np.float32)
    for b in range(batch):
        pts[b] = rng.uniform(-70, 70, (n_points, 5)).astype(np.float32)
        pts[b, :, 2] = rng.uniform(-1.5, 3.5, n_points)
    return pts, np.ones((batch, n_points), bool)


def make_gt(batch, n_slots, n_valid, half_extent, seed=1):
    """GT boxes (batch, n_slots, 9) [x, y, z, dx, dy, dz, heading, vx, vy]:
    classes 0/1/2 in turn with class-typical sizes jittered by +-20%,
    centres uniform in +-half_extent, z in [-1, 1], headings uniform,
    velocities in +-5 m/s; the first n_valid slots valid."""
    rng = np.random.RandomState(seed)
    cls = np.arange(n_slots) % 3
    gb = np.zeros((batch, n_slots, 9), np.float32)
    gb[..., :2] = rng.uniform(-half_extent, half_extent, (batch, n_slots, 2))
    gb[..., 2] = rng.uniform(-1, 1, (batch, n_slots))
    gb[..., 3:6] = GT_SIZES[cls] * rng.uniform(0.8, 1.2, (batch, n_slots, 3))
    gb[..., 6] = rng.uniform(-np.pi, np.pi, (batch, n_slots))
    gb[..., 7:9] = rng.uniform(-5, 5, (batch, n_slots, 2))
    gv = np.zeros((batch, n_slots), bool)
    gv[:, :n_valid] = True
    return gb, np.tile(cls, (batch, 1)).astype(np.int32), gv


def train_batch(pts, pv, gt, device):
    import torch

    arrays = dict(points=pts, points_valid=pv, gt_boxes=gt[0],
                  gt_classes=gt[1], gt_valid=gt[2])
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# cycles a second for time_ms's spin kernel: at or above the H100's boost
# clock, so the spin lasts at least as long as asked
CARD_HZ = 2.0e9


def time_ms(fn, iters=10, warmup=2):
    """The card's ms for one call of fn, from CUDA events around `iters`
    calls.  A spin kernel queued before the first event holds the card
    while the host enqueues the calls (1.5 times one call's synchronised
    host time each), so the events read the kernels back to back, not the
    host's enqueue, where a call's Python and launch cost outlasts its
    kernels."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(CARD_HZ * 1.5 * iters * host_s) + 10_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, ops, kind):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the card's peak for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def with_bound(rec, n_bytes, ops, kind):
    rec["bound_ms"], rec["bound_by"] = bound(n_bytes, ops, kind)
    return rec


def clip_ops(a, b, pairwise=False, iou=False):
    """CLIP_OPS summed over these BEV boxes (N, 5) x (M, 5) (or N matched
    pairs): the cull's side tests at the edges it tests
    (`iou_bev._clip_class`), and for the pairs it cannot tell the live
    vertices and crossings at each edge that the plain clip traces on these
    inputs."""
    import torch
    from detzero_tpu_torch.ops import iou_bev

    ca, cb = iou_bev._corners(a.float()), iou_bev._corners(b.float())
    if pairwise:
        shape = (a.shape[0],)
    else:
        shape = (a.shape[0], b.shape[0])
        ca = [(x[:, None], y[:, None]) for x, y in ca]
        cb = [(x[None, :], y[None, :]) for x, y in cb]
    cls, tested = iou_bev._clip_class(ca, cb, shape)
    live = []
    iou_bev._clip_area(ca, cb, shape, live=live)
    c = CLIP_OPS
    clip = (cls == iou_bev.CLIP_NEEDED).double()
    per_pair = c["edge_test"] * tested.double() + c["iou"] * iou
    for n_in, n_kept, n_out in live:
        per_pair = per_pair + clip * (n_in * c["vertex"]
                                      + (n_out - n_kept) * c["crossing"])
    n = live[-1][2]
    per_pair = per_pair + clip * (n >= 3) * (c["area"]
                                            + n * c["area_vertex"])
    n_boxes = a.shape[0] + (0 if a is b else b.shape[0])
    return float(per_pair.sum()) + c["box"] * n_boxes


def sum_cases(cases):
    """One record for a kernel timed at several shapes: the worst error,
    the summed times (the library call's too, where it has one) and bounds,
    bound_by of the largest bound."""
    top = max(cases, key=lambda c: c["bound_ms"])
    rec = dict(max_abs_err=max(c["max_abs_err"] for c in cases),
               ms=sum(c["ms"] for c in cases),
               plain_ms=sum(c["plain_ms"] for c in cases),
               bound_ms=sum(c["bound_ms"] for c in cases),
               bound_by=top["bound_by"], cases=cases)
    if "library_ms" in top:
        rec["library_ms"] = sum(c["library_ms"] for c in cases)
    if "launches" in top:
        # kernel ms of one run of the path: each shape's time times its
        # launches there
        rec["weighted_ms"] = sum(c["ms"] * c["launches"] for c in cases)
        rec["weighted_bound_ms"] = sum(c["bound_ms"] * c["launches"]
                                       for c in cases)
    return rec


def conv_reads(nbr, zm_in, zm_out, nz, mode, z_stride):
    """(input sites read, pairs) of one row-pad conv on these maps: the
    occupied input sites that some occupied output site reads through a
    tap, and the (occupied output site, occupied input tap) pairs, each one
    cin x cout product, all the work the conv (and its weight gradient)
    needs.  zm_in is the input table's zmask (nz // 2 planes in 'up'
    mode), nz the input nz ('up': the output's)."""
    import torch

    ny_in, planes, b_in = zm_in.shape
    y, z, r = torch.nonzero(zm_out, as_tuple=True)
    occ_in = zm_in.reshape(-1)
    read = torch.zeros_like(occ_in)
    pairs = 0
    for j in range(9):
        dy = j // 3 - 1
        if mode == "subm":
            src = y + dy
        elif mode == "down":
            src = 2 * y + dy
        else:
            src = torch.div(y + dy, 2, rounding_mode="floor")
        src = src.clamp(0, ny_in - 1)
        rank = nbr[y, j, r].long()
        found = (rank >= 0) & (rank < b_in)
        for t in range(3):
            zi = z * z_stride + t - 1
            ok = found & (zi >= 0) & (zi < nz)
            if mode == "up":
                ok &= zi % 2 == 0
                zi = torch.div(zi, 2, rounding_mode="floor")
            idx = ((src * planes + zi.clamp(0, planes - 1)) * b_in
                   + rank.clamp(0, b_in - 1))
            ok &= occ_in[idx]
            pairs += int(ok.sum())
            read[idx[ok]] = True
    return int(read.sum()), pairs


def conv_work(nbr, zm_in, zm_out, nz, cin, cout, mode, z_stride, *,
              dw=False, epilogue=False, residual=False):
    """(bytes, ops) of one row-pad conv (K2, K4, K9) or, with `dw`, its
    weight gradient (K5), counting what these inputs need (a sparse
    product): the bf16 input values of the occupied sites that some
    occupied output reads; the zmask in full (one byte a site) and the
    nine map rows read; for a conv the bf16 weight and the bf16 output in
    full (the kernel writes every site), and for K2 the f32 scale and bias
    and the residual at the occupied outputs; for K5 the bf16 output
    gradient at the occupied outputs and the f32 (27, cin, cout) result.
    Operations: 2 * cin * cout per pair."""
    n_read, pairs = conv_reads(nbr, zm_in, zm_out, nz, mode, z_stride)
    n_out = int(zm_out.sum())
    ny_out, onz, b_out = zm_out.shape
    n_bytes = 2 * n_read * cin + zm_out.numel() + 9 * ny_out * b_out * 4
    if dw:
        n_bytes += 2 * n_out * cout + 4 * 27 * cin * cout
    else:
        n_bytes += 2 * 27 * cin * cout + 2 * zm_out.numel() * cout
        n_bytes += 8 * cout * epilogue + 2 * n_out * cout * residual
    return n_bytes, 2.0 * cin * cout * pairs


# the 3D backbone's channels per level (PallasResBackbone8x)
CHANNELS = (16, 32, 64, 128)


def conv_shapes(kernel, stem_cin):
    """Every distinct conv that a path launches `kernel` at, as (name, mode,
    input level, output level, cin, cout, residual, launches a run): 'K2'
    per frame (one-stage or two-stage: the stem, two 'subm' convs without
    and two with the residual per level, three 'down' convs); 'K4' per
    training step (the 20 forward convs, then the 19 input gradients:
    'subm' for the 16 block convs, 'up' for the 3 strided convs; the stem's
    input needs none); 'K5' per training step (each forward conv's weight
    gradient)."""
    c = CHANNELS
    out = [(f"stem L0 {stem_cin}->{c[0]}", "subm", 0, 0, stem_cin, c[0],
            False, 1)]
    for lv in range(4):
        sub = (f"L{lv} subm {c[lv]}->{c[lv]}", "subm", lv, lv, c[lv], c[lv])
        if kernel == "K2":
            out += [sub + (False, 2), (sub[0] + " +res",) + sub[1:]
                    + (True, 2)]
        else:
            out.append(sub + (False, 8 if kernel == "K4" else 4))
        if lv < 3:
            out.append((f"down L{lv}->L{lv + 1} {c[lv]}->{c[lv + 1]}",
                        "down", lv, lv + 1, c[lv], c[lv + 1], False, 1))
            if kernel == "K4":
                out.append((f"up L{lv + 1}->L{lv} {c[lv + 1]}->{c[lv]}",
                            "up", lv + 1, lv, c[lv + 1], c[lv], False, 1))
    return out


def conv_args(plan, mode, lv_in, lv_out):
    """(neighbour map, input zmask, output zmask, input nz as the kernel
    takes it, z stride) of a conv between two levels of a row-pad plan."""
    zm_in, zm_out = plan[lv_in]["rp_zmask"], plan[lv_out]["rp_zmask"]
    if mode == "up":      # the transpose of lv_out's down conv
        return (plan[lv_out]["rp_up_nbr"], zm_in, zm_out, zm_out.shape[1],
                1)
    key = "rp_down_nbr" if mode == "down" else "rp_nbr"
    return (plan[lv_in][key], zm_in, zm_out, zm_in.shape[1],
            2 if mode == "down" else 1)


def nbr_cases(plan):
    """The 10 neighbour maps of a row-pad plan as (name, xq, x_in, mode),
    the x-coords rebuilt from the plan as augment_plan_rowpad builds them."""
    from detzero_tpu_torch.ops import pillars

    xq = [pillars.rowpad_xcoords(e["coords2d"][:, 1], e["rp_gidx"],
                                 e["rp_gvalid"]) for e in plan[:4]]
    cases = [(f"subm L{lv}", xq[lv], xq[lv], "subm") for lv in range(4)]
    for lv in range(3):
        cases += [(f"down L{lv}->L{lv + 1}", xq[lv + 1], xq[lv], "down"),
                  (f"up L{lv + 1}->L{lv}", xq[lv], xq[lv + 1], "up")]
    return cases


def _nbr_taps(xq, x_in, mode):
    """Per tap row dy (3, ny_out): the clamped target row and whether it
    exists; per dx (3, ny_out, b_out): the target x-coord and whether the
    query is live and x' whole ('up')."""
    import torch
    from detzero_tpu_torch.ops.pillars import NBR_BIG

    ny_in = x_in.shape[0]
    i = torch.arange(xq.shape[0], device=xq.device)
    d = torch.arange(-1, 2, dtype=xq.dtype, device=xq.device)
    s = (2 * i if mode == "down" else i)[None, :] + d[:, None]
    if mode == "up":
        rv = (s >= 0) & (s % 2 == 0) & (s // 2 < ny_in)
        s = torch.div(s, 2, rounding_mode="floor")
    else:
        rv = (s >= 0) & (s < ny_in)
    q = xq[None] + d[:, None, None]
    ok = (xq < NBR_BIG)[None].expand_as(q)
    if mode == "down":
        q = 2 * xq[None] + d[:, None, None]
    elif mode == "up":
        ok = ok & ((q + 2) % 2 == 0)
        q = torch.div(q + 2, 2, rounding_mode="floor") - 1
    return s.clamp(0, ny_in - 1), rv, q, ok


def nbr_ops(xq, x_in, mode):
    """The integer operations K8 needs on these inputs: for each live query
    and each tap whose target row exists (and, in 'up', whose x' is whole),
    a binary search over the target row's live x-coords, ceil(log2(live +
    1)) compares, and the equality test at the found rank."""
    import torch
    from detzero_tpu_torch.ops.pillars import NBR_BIG

    rows, rv, _, ok = _nbr_taps(xq, x_in, mode)
    live = (x_in < NBR_BIG).sum(1).double()[rows]            # (3, ny_out)
    steps = (torch.ceil(torch.log2(live + 1)) + 1) * rv      # (3, ny_out)
    per_row = ok.sum(2).double()                             # (3dx, ny_out)
    return float((steps[:, None, :] * per_row[None]).sum())


def nbr_searchsorted(xq, x_in, mode):
    """K8's yardstick: one `torch.searchsorted` of the 9 taps' x' in their
    x-sorted target rows (the lower bound of x' is the count of smaller
    x-coords, the fill NBR_BIG sorting last) plus the found test, as the
    map (ny_out, 16, b_out)."""
    import torch

    rows, rv, q, ok = _nbr_taps(xq, x_in, mode)
    b_in = x_in.shape[1]
    ny_out, b_out = xq.shape
    xt = x_in[rows]                                  # (3dy, ny_out, b_in)
    vals = q.permute(1, 0, 2).reshape(1, ny_out, 3 * b_out).expand(
        3, -1, -1).contiguous()                      # (3dy, ny_out, 3dx*b)
    rank = torch.searchsorted(xt, vals, out_int32=True)
    fnd = torch.gather(xt, 2, rank.clamp(max=b_in - 1).long()) == vals
    fnd &= rv[:, :, None]
    fnd &= ok.permute(1, 0, 2).reshape(1, ny_out, 3 * b_out)
    nbr = torch.where(fnd, rank, b_in).reshape(3, ny_out, 3, b_out)
    nbr = nbr.permute(1, 0, 2, 3).reshape(ny_out, 9, b_out)
    return torch.cat([nbr, nbr.new_full((ny_out, 7, b_out), b_in)], 1)


def check_nbr(plan):
    """K8 on the card, all 10 maps of this plan in its one launch, against
    its plain version (`pillars.rowpad_nbr_rank`): integers, equal on every
    element; its `torch.searchsorted` yardstick must build the same maps.
    Times the one launch against the plain maps and the yardstick summed
    over the 10.  Returns K8's record, one case a map (each with its plain
    and yardstick ms and its bound)."""
    import torch
    from detzero_tpu_torch.ops import pillars, rowpad_nbr

    named = nbr_cases(plan)
    args = [(q, x_in, mode) for _, q, x_in, mode in named]
    n0 = rowpad_nbr.LAUNCHES
    maps = rowpad_nbr.rowpad_nbr_maps(args)
    torch.cuda.synchronize()
    if rowpad_nbr.LAUNCHES != n0 + 1:
        raise AssertionError(f"rowpad_nbr_maps: {rowpad_nbr.LAUNCHES - n0} "
                             f"launches for {len(args)} maps, expected 1")
    cases = []
    for (name, q, x_in, mode), got in zip(named, maps):
        ref = pillars.rowpad_nbr_rank(q, x_in, mode)
        lib = nbr_searchsorted(q, x_in, mode)
        torch.cuda.synchronize()
        diff = int((got != ref).sum())
        if diff or not torch.equal(lib, ref):
            raise AssertionError(f"rowpad_nbr {name}: {diff} elements differ "
                                 f"from the plain version; yardstick equal: "
                                 f"{torch.equal(lib, ref)}")
        pms = time_ms(lambda: pillars.rowpad_nbr_rank(q, x_in, mode),
                      iters=3)
        lms = time_ms(lambda: nbr_searchsorted(q, x_in, mode), iters=3)
        rc = with_bound(dict(case=name, max_abs_err=float(diff), ms=0.0,
                             plain_ms=pms, library_ms=lms),
                        nbytes(q, x_in, got), nbr_ops(q, x_in, mode), "f32")
        cases.append(rc)
        print(f"[kernels] rowpad_nbr {name} {tuple(got.shape)}: "
              f"{int((ref[:, :9] < x_in.shape[1]).sum())} taps found, 0 "
              f"elements differ, plain {pms:.3f} ms, searchsorted "
              f"yardstick {lms:.3f} ms, bound {rc['bound_ms']:.5f} ms "
              f"({rc['bound_by']})")
    rec = sum_cases(cases)
    rec["ms"] = time_ms(lambda: rowpad_nbr.rowpad_nbr_maps(args))
    print(f"[kernels] rowpad_nbr_maps, all {len(args)} maps in one launch: "
          f"{rec['ms']:.4f} ms vs plain {rec['plain_ms']:.3f} ms, "
          f"searchsorted yardstick {rec['library_ms']:.3f} ms (summed over "
          f"the maps), bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def clustered_boxes(device, n=200, per=5, seed=2):
    """n clusters of `per` jittered BEV boxes (real overlaps)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    base = torch.rand((n, 1, 5), generator=g)
    base = base * torch.tensor([80.0, 80.0, 4.0, 2.0, 6.283]) \
        + torch.tensor([-40.0, -40.0, 1.0, 1.0, -3.1416])
    jit = torch.randn((n, per, 5), generator=g) \
        * torch.tensor([0.3, 0.3, 0.2, 0.1, 0.2])
    boxes = (base + jit).reshape(n * per, 5)
    boxes[:, 2:4] = boxes[:, 2:4].abs() + 0.2
    return boxes.to(device)


def masked_table(zmask, c, gen):
    """A random bf16 (ny, nz*c, B) table of a level, zero at the sites its
    zmask (ny, nz, B) marks empty, as the model's tables are."""
    import torch

    t = torch.randn((zmask.shape[0], zmask.shape[1], c, zmask.shape[2]),
                    generator=gen, device=zmask.device)
    return (t * zmask[:, :, None, :]).reshape(zmask.shape[0], -1,
                                              zmask.shape[2]).bfloat16()


def build_model(cfg, kw, dtype, device, seed=0):
    """Random weights drawn on the CPU from `seed` (the same on every
    device), then moved to `device`."""
    import torch
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    model = CenterPoint(cfg, 3, dtype=dtype, device="cpu", **kw)
    model.init_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def check_kernels(model, pts, pv, device):
    """Phase 3: every kernel of the path against its plain version on the
    card, on the flagship frame's own tensors.  Returns {name: record}."""
    import torch
    from detzero_tpu_torch.ops import iou_bev, nms, rowpad_conv, stream_vfe

    rec = {}
    gen = torch.Generator(device=device).manual_seed(1)
    p = torch.from_numpy(pts[0]).to(device)
    v = torch.from_numpy(pv[0]).to(device)
    table = model.build_table(p, v)
    plan = model.build_plan(table)
    s = table["stream"]
    nz, ny = model.grid_zyx[0], model.grid_zyx[1]
    kw = dict(nz=nz, ny=ny, row_budget=model.row_budget,
              out_dtype=torch.bfloat16)
    args = (s["payload"], s["lane"], s["z"], s["wstart"])

    # K1: bf16 means from f32 sums; the sums agree to f32 rounding, so the
    # stored means agree to one bf16 ulp: tolerance 2^-7 * max|ref|
    ref = stream_vfe.stream_rowpad_feats_plain(*args, **kw)
    got = stream_vfe.stream_rowpad_feats(*args, **kw)
    torch.cuda.synchronize()
    err, tol = max_abs(got, ref), 2 ** -7 * float(ref.float().abs().max())
    ms = time_ms(lambda: stream_vfe.stream_rowpad_feats(*args, **kw))
    pms = time_ms(lambda: stream_vfe.stream_rowpad_feats_plain(*args, **kw),
                  iters=3)
    print(f"[kernels] stream_rowpad_feats {tuple(got.shape)}: max_abs_err "
          f"{err:.3g} (tol {tol:.3g}), {ms:.3f} ms vs plain {pms:.3f} ms")
    if not err <= tol:
        raise AssertionError("stream_rowpad_feats disagrees with its plain "
                             "version")
    # bytes: the stream read once, the table written once; operations: one
    # add per payload element, one divide per output element (f32)
    rec["stream_rowpad_feats"] = with_bound(
        dict(max_abs_err=err, ms=ms, plain_ms=pms), nbytes(*args, got),
        args[0].numel() + got.numel(), "f32")
    rp_feats = got

    # K2 at every distinct conv of the frame.  Tolerance 2e-2 * max|ref|:
    # both sides read the same bf16 inputs and round to bf16 once; only
    # the f32 summation order differs.
    def fused_case(name, mode, lv_in, lv_out, cin, cout, res, n):
        nbr, zm_in, zm, nz_in, z_stride = conv_args(plan, mode, lv_in,
                                                    lv_out)
        table_in = rp_feats if name.startswith("stem") \
            else masked_table(zm_in, cin, gen)
        w = torch.randn((27, cin, cout), generator=gen, device=device) \
            * (27 * cin) ** -0.5
        sc = torch.rand(cout, generator=gen, device=device) + 0.5
        bi = torch.randn(cout, generator=gen, device=device) * 0.1
        residual = masked_table(zm, cout, gen) if res else None
        ckw = dict(nz=nz_in, cin=cin, cout=cout, out_nz=zm.shape[1],
                   mode=mode, z_stride=z_stride, relu=True)
        a = (table_in, nbr, w, sc, bi, zm, residual)
        ref = rowpad_conv.rowpad_conv_fused_plain(*a, **ckw)
        got = rowpad_conv.rowpad_conv_fused(*a, **ckw)
        torch.cuda.synchronize()
        err = max_abs(got, ref)
        tol = 2e-2 * max(float(ref.float().abs().max()), 1e-3)
        del ref
        ms = time_ms(lambda: rowpad_conv.rowpad_conv_fused(*a, **ckw))
        pms = time_ms(lambda: rowpad_conv.rowpad_conv_fused_plain(*a, **ckw),
                      iters=2, warmup=1)
        work = conv_work(nbr, zm_in, zm, nz_in, cin, cout, mode, z_stride,
                         epilogue=True, residual=res)
        rc = with_bound(dict(case=name, launches=n, max_abs_err=err, tol=tol,
                             ms=ms, plain_ms=pms), *work, "bf16")
        torch.cuda.empty_cache()
        print(f"[kernels] rowpad_conv_fused {name} in {tuple(a[0].shape)} "
              f"out {tuple(got.shape)}, {n} a frame: max_abs_err {err:.3g} "
              f"(tol {tol:.3g}), {ms:.4f} ms vs plain {pms:.3f} ms, bound "
              f"{rc['bound_ms']:.4f} ms ({rc['bound_by']})")
        if not err <= tol:
            raise AssertionError(f"rowpad_conv_fused {name} disagrees")
        return rc

    stem_cin = rp_feats.shape[1] // nz
    rec["rowpad_conv_fused"] = sum_cases(
        [fused_case(*c) for c in conv_shapes("K2", stem_cin)])
    print(f"[kernels] rowpad_conv_fused launch-weighted: "
          f"{rec['rowpad_conv_fused']['weighted_ms']:.3f} ms a frame "
          f"(bound {rec['rowpad_conv_fused']['weighted_bound_ms']:.3f} ms)")
    # K8 on the 10 maps of this frame's plan
    rec["rowpad_nbr"] = check_nbr(plan)

    # K3 on 1000 x 1000 boxes with real overlaps: 200 clusters of 5
    # jittered boxes.  Both versions round every operation alike; the
    # tolerance 1e-5 absolute covers sin/cos differing in the last ulp.
    boxes = clustered_boxes(device)
    ref = iou_bev.boxes_iou_bev_plain(boxes, boxes)
    got = iou_bev.boxes_iou_bev(boxes, boxes)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    ms = time_ms(lambda: iou_bev.boxes_iou_bev(boxes, boxes))
    pms = time_ms(lambda: iou_bev.boxes_iou_bev_plain(boxes, boxes), iters=3)
    n_over = int((got > 0.7).sum()) - 1000
    print(f"[kernels] boxes_iou_bev 1000x1000 ({n_over} off-diagonal pairs "
          f"> 0.7): max_abs_err {err:.3g} (tol 1e-05), {ms:.3f} ms vs plain "
          f"{pms:.3f} ms")
    if not err <= 1e-5:
        raise AssertionError("boxes_iou_bev disagrees with its plain version")
    rec["boxes_iou_bev"] = with_bound(
        dict(max_abs_err=err, ms=ms, plain_ms=pms), nbytes(boxes, boxes, got),
        clip_ops(boxes, boxes, iou=True), "f32")

    # K3 on this frame's own NMS input, with the walk's keep mask against
    # the plain walk's on the plain matrix
    rec["boxes_iou_bev"]["frame"] = check_frame_nms(model, p, v)

    # the walk on that matrix: keep masks must be equal
    valid = torch.ones(1000, dtype=torch.bool, device=device)
    valid[::17] = False
    keep_ref = nms.nms_walk_plain(got, valid, 0.7)
    keep = nms.nms_walk(got, valid, 0.7)
    torch.cuda.synchronize()
    diff = int((keep != keep_ref).sum())
    ms = time_ms(lambda: nms.nms_walk(got, valid, 0.7))
    pms = time_ms(lambda: nms.nms_walk_plain(got, valid, 0.7), iters=2,
                  warmup=1)
    print(f"[kernels] nms_walk k=1000: {int(keep.sum())} kept, {diff} "
          f"differ from plain (must be 0), {ms:.3f} ms vs plain {pms:.3f} ms")
    if diff:
        raise AssertionError("nms_walk keep mask differs from its plain "
                             "version")
    # one compare per (box, later box) pair at most, k^2 f32 operations
    rec["nms_walk"] = with_bound(
        dict(max_abs_err=float(diff), ms=ms, plain_ms=pms),
        nbytes(got) + 2 * valid.numel(), got.numel(), "f32")
    return rec


def frame_nms_input(model, p, v):
    """The BEV boxes (k, 5), valid mask and threshold that one predict of
    (p, v) hands to K3 and the walk (`nms.nms_bev`: the decoded top-k
    boxes of both heads, k <= NMS_PRE_MAXSIZE 1024), recorded by wrapping
    the two for this one call.  Score threshold 0, so that the walk has
    valid boxes at random weights."""
    from detzero_tpu_torch.ops import nms

    seen = {}
    iou_fn, walk_fn = nms.boxes_iou_bev, nms.nms_walk

    def iou_rec(a, b):
        seen["boxes"] = a.clone()
        return iou_fn(a, b)

    def walk_rec(iou, valid, thresh):
        seen["valid"], seen["thresh"] = valid.clone(), thresh
        return walk_fn(iou, valid, thresh)

    nms.boxes_iou_bev, nms.nms_walk = iou_rec, walk_rec
    try:
        model.predict(p[None], v[None], score_thresh=0.0)
    finally:
        nms.boxes_iou_bev, nms.nms_walk = iou_fn, walk_fn
    return seen["boxes"], seen["valid"], seen["thresh"]


def check_frame_nms(model, p, v):
    """K3 on the frame's own NMS input against its plain version (1e-5
    absolute, as on the clustered boxes), and the walk's keep mask on K3's
    matrix equal to the plain walk's on the plain matrix.  Returns the
    record, timed and bounded there."""
    import torch
    from detzero_tpu_torch.ops import iou_bev, nms

    boxes, valid, thresh = frame_nms_input(model, p, v)
    ref = iou_bev.boxes_iou_bev_plain(boxes, boxes)
    got = iou_bev.boxes_iou_bev(boxes, boxes)
    keep_ref = nms.nms_walk_plain(ref, valid, thresh)
    keep = nms.nms_walk(got, valid, thresh)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    diff = int((keep != keep_ref).sum())
    ms = time_ms(lambda: iou_bev.boxes_iou_bev(boxes, boxes))
    pms = time_ms(lambda: iou_bev.boxes_iou_bev_plain(boxes, boxes), iters=3)
    rc = with_bound(dict(max_abs_err=err, ms=ms, plain_ms=pms),
                    nbytes(boxes, boxes, got),
                    clip_ops(boxes, boxes, iou=True), "f32")
    n_clip = int((iou_bev.clip_class_plain(boxes, boxes)
                  == iou_bev.CLIP_NEEDED).sum())
    print(f"[kernels] boxes_iou_bev on the frame's NMS input "
          f"{tuple(got.shape)} ({n_clip} pairs need the clip, "
          f"{int(valid.sum())} valid, {int(keep.sum())} kept at "
          f"{thresh}): max_abs_err {err:.3g} (tol 1e-05), keep masks differ "
          f"at {diff} (must be 0), {ms:.4f} ms vs plain {pms:.3f} ms, bound "
          f"{rc['bound_ms']:.5f} ms ({rc['bound_by']})")
    if not (err <= 1e-5 and diff == 0):
        raise AssertionError("boxes_iou_bev on the frame's NMS input "
                             "disagrees with its plain version")
    return rc


def ptxas_report(log):
    """{kernel's mangled name: (registers, stack frame bytes, spill stores,
    spill loads)} from nvcc's -Xptxas -v report."""
    import re

    out, name, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, props = m.group(1), None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and props is not None:
            out[name] = (int(m.group(1)),) + props
            name, props = None, None
    return out


def print_ptxas(log):
    """Phase 2: each entry function's registers, stack frame and spills;
    fails unless every instance of NO_STACK_KERNELS has neither a stack
    frame nor spills."""
    report = ptxas_report(log)
    for name, (regs, stack, st, ld) in sorted(report.items()):
        print(f"[build] {name}: {regs} registers, {stack} bytes stack "
              f"frame, {st} bytes spill stores, {ld} bytes spill loads")
    for kern in NO_STACK_KERNELS:
        hits = {n: r for n, r in report.items() if kern in n}
        if not hits or any(r[1:] != (0, 0, 0) for r in hits.values()):
            raise AssertionError(f"{kern}: ptxas report {hits}, expected no "
                                 f"stack frame and no spills")


def _counter_module(name):
    import importlib

    return importlib.import_module(
        f"detzero_tpu_torch.ops.{COUNTERS[name][0]}")


def reset_counts():
    for name, (_, attr) in COUNTERS.items():
        setattr(_counter_module(name), attr, 0)


def read_counts():
    return {name: getattr(_counter_module(name), attr)
            for name, (_, attr) in COUNTERS.items()}


class StageEvents:
    """A `stage_hook` of the model (and trainer): records a CUDA event
    where each stage begins; `ms()` -> {stage: ms} summed over a stage's
    repeats (the samples of a batch), each stage ending where the next
    begins and the last at `ms()`'s own event."""

    def __init__(self):
        self.marks = []

    def __call__(self, name):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def ms(self):
        import torch

        self("end")
        torch.cuda.synchronize()
        out = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def stage_times(run, hooked, calls=1):
    """Per-stage ms of `run()`, mean over `calls` calls, from the stage
    hooks of the objects in `hooked` (the model's own stage boundaries)."""
    tot = {}
    for _ in range(calls):
        ev = StageEvents()
        for obj in hooked:
            obj.stage_hook = ev
        run()
        for obj in hooked:
            obj.stage_hook = None
        for k, t in ev.ms().items():
            tot[k] = tot.get(k, 0.0) + t / calls
    return tot


def run_predict(device):
    """Phase 4.  Returns {kernel name: launches in the counted frame}."""
    import torch

    pts, pv = entry_points()
    model = build_model(FLAGSHIP_CFG, FLAGSHIP_KW, torch.bfloat16, device)
    p = torch.from_numpy(pts).to(device)
    v = torch.from_numpy(pv).to(device)
    for _ in range(2):                               # warm-up frames
        model.predict(p, v)
    torch.cuda.synchronize()

    reset_counts()
    out = model.predict(p, v)                        # the counted frame
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"[predict] launches in one frame: {launches}")
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"stream_rowpad_feats": 1, "rowpad_conv_fused": 20,
                 "boxes_iou_bev": 1, "nms_walk": 1,
                 "rowpad_nbr": NBR_LAUNCHES})
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    for k, t in out.items():
        if t.is_floating_point() and not torch.isfinite(t).all():
            raise AssertionError(f"non-finite predict output {k}")
    if tuple(out["boxes"].shape) != (1, 256, 9):
        raise AssertionError(f"boxes shape {tuple(out['boxes'].shape)}")
    print(f"[predict] outputs finite; boxes {tuple(out['boxes'].shape)}, "
          f"{int(out['mask'].sum())} kept")
    # random weights leave no score above the default 0.1: with a threshold
    # of 0 the walk must keep (and suppress) real boxes
    n_kept = int(model.predict(p, v, score_thresh=0.0)["mask"].sum())
    print(f"[predict] score_thresh 0: {n_kept} of 256 kept")
    if not 0 < n_kept:
        raise AssertionError("NMS kept nothing at score_thresh 0")

    torch.cuda.reset_peak_memory_stats(device)
    frames = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        model.predict(p, v)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / frames
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"[predict] flagship {frames} frames: {ms:.2f} ms/frame, "
          f"{1000.0 / ms:.3f} frames/s, peak memory {peak:.2f} GiB")
    st = stage_times(lambda: model.predict(p, v), [model], calls=3)
    print("[predict] stage ms: " + ", ".join(
        f"{k} {t:.2f}" for k, t in st.items()))
    return launches


def check_tiny(device):
    """The card (kernels, bf16) against the CPU (plain versions, f32) on the
    tiny geometry with the same weights: the plan's 10 neighbour maps (K8
    on the card) equal to the CPU's; the head outputs within 5e-2 *
    max(|ref|, 1), since bf16 rounds at every layer (2^-8 relative) and over
    the ~30 layers of the path that grows to about 2e-2."""
    import torch
    from detzero_tpu_torch.ops import rowpad_nbr

    pts, pv = entry_points(2048, seed=0)
    pts[..., :2] *= 6.0 / 70.0
    pts[..., 2] = np.clip(pts[..., 2], -1.8, 1.8)
    cpu = build_model(TINY_CFG, TINY_KW, torch.float32, "cpu")
    gpu = build_model(TINY_CFG, TINY_KW, torch.bfloat16, device)
    gpu.load_state_dict(cpu.state_dict())
    plans = []
    reset_counts()
    for model, dev in ((cpu, "cpu"), (gpu, device)):
        p, v = (torch.from_numpy(a[0]).to(dev) for a in (pts, pv))
        plans.append(model.build_plan(model.build_table(p, v)))
    n_maps = 0
    for lv, (c, g) in enumerate(zip(*plans)):
        for key in ("rp_nbr", "rp_down_nbr", "rp_up_nbr"):
            if key in c:
                n_maps += 1
                if not torch.equal(g[key].cpu(), c[key]):
                    raise AssertionError(f"tiny plan L{lv} {key}: the card's "
                                         f"map differs from the CPU's")
    if (n_maps, rowpad_nbr.LAUNCHES) != (NBR_MAPS, NBR_LAUNCHES):
        raise AssertionError(f"tiny plan: {n_maps} maps compared, "
                             f"{rowpad_nbr.LAUNCHES} K8 launches")
    print(f"[predict] tiny plan card vs CPU: all {n_maps} neighbour maps "
          f"equal")
    ref = cpu.forward_one(torch.from_numpy(pts[0]), torch.from_numpy(pv[0]))
    got = gpu.forward_one(torch.from_numpy(pts[0]).to(device),
                          torch.from_numpy(pv[0]).to(device))
    worst = 0.0
    for r, g in zip(ref, got):
        for k in r:
            err = max_abs(g[k].cpu(), r[k])
            tol = 5e-2 * max(float(r[k].abs().max()), 1.0)
            worst = max(worst, err / tol)
            if not err <= tol:
                raise AssertionError(f"tiny head output {k}: {err} > {tol}")
    print(f"[predict] tiny geometry card vs CPU: worst err/tol {worst:.3f}")


def check_train_kernels(model, batch, device):
    """Phase 5: K4 and K5 against their plain versions on the card, at every
    distinct conv of the flagship training step: the batch's tables and
    maps stacked along the BEV-row axis, as CenterPoint.loss runs them.
    Returns {name: record}."""
    import torch
    from detzero_tpu_torch.ops import rowpad_conv

    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        rp_feats, plan = model.prepare(batch["points"],
                                       batch["points_valid"])
    stem_cin = rp_feats.shape[1] // plan[0]["rp_zmask"].shape[1]

    def table_for(name, zm_in, cin):
        return rp_feats if name.startswith("stem") \
            else masked_table(zm_in, cin, gen)

    def conv_case(name, mode, lv_in, lv_out, cin, cout, _, n):
        """K4 with the output level's zmask, on bf16-rounded weights, so
        both sides multiply the same values: 2e-2 * max|ref| for f32 sums
        in another order and one bf16 rounding of the output."""
        nbr, zm_in, zm, nz_in, z_stride = conv_args(plan, mode, lv_in,
                                                    lv_out)
        table = table_for(name, zm_in, cin)
        w = (torch.randn((27, cin, cout), generator=gen, device=device)
             * (27 * cin) ** -0.5).bfloat16().float()
        ckw = dict(nz=nz_in, cin=cin, cout=cout, out_nz=zm.shape[1],
                   mode=mode, z_stride=z_stride)
        a = (table, nbr, w, zm)
        ref = rowpad_conv.rowpad_conv_plain(*a, **ckw)
        got = rowpad_conv.rowpad_conv(*a, **ckw)
        torch.cuda.synchronize()
        err = max_abs(got, ref)
        tol = 2e-2 * max(float(ref.abs().max()), 1e-3)
        del ref
        ms = time_ms(lambda: rowpad_conv.rowpad_conv(*a, **ckw))
        pms = time_ms(lambda: rowpad_conv.rowpad_conv_plain(*a, **ckw),
                      iters=2, warmup=1)
        work = conv_work(nbr, zm_in, zm, nz_in, cin, cout, mode, z_stride)
        rc = with_bound(dict(case=name, launches=n, max_abs_err=err, tol=tol,
                             ms=ms, plain_ms=pms), *work, "bf16")
        torch.cuda.empty_cache()
        print(f"[train-kernels] rowpad_conv {name} in {tuple(table.shape)} "
              f"out {tuple(got.shape)}, {n} a step: max_abs_err {err:.3g} "
              f"(tol {tol:.3g}), {ms:.4f} ms vs plain {pms:.3f} ms, bound "
              f"{rc['bound_ms']:.4f} ms ({rc['bound_by']})")
        if not err <= tol:
            raise AssertionError(f"rowpad_conv {name} disagrees")
        return rc

    def dw_case(name, mode, lv_in, lv_out, cin, cout, _, n):
        """K5 with a random output gradient that is zero at empty sites, as
        the model's is: the same bf16 products summed in f32 in another
        order, 1e-3 * max|ref|; two launches give the same bits."""
        nbr, zm_in, zm, nz_in, z_stride = conv_args(plan, mode, lv_in,
                                                    lv_out)
        table = table_for(name, zm_in, cin)
        d_out = masked_table(zm, cout, gen)
        ckw = dict(nz=nz_in, cin=cin, cout=cout, out_nz=zm.shape[1],
                   mode=mode, z_stride=z_stride)
        a = (table, nbr, d_out, zm)
        ref = rowpad_conv.rowpad_conv_dw_plain(*a, **ckw)
        got = rowpad_conv.rowpad_conv_dw(*a, **ckw)
        again = rowpad_conv.rowpad_conv_dw(*a, **ckw)
        torch.cuda.synchronize()
        err = max_abs(got, ref)
        tol = 1e-3 * max(float(ref.abs().max()), 1e-6)
        ms = time_ms(lambda: rowpad_conv.rowpad_conv_dw(*a, **ckw))
        pms = time_ms(lambda: rowpad_conv.rowpad_conv_dw_plain(*a, **ckw),
                      iters=2, warmup=1)
        work = conv_work(nbr, zm_in, zm, nz_in, cin, cout, mode, z_stride,
                         dw=True)
        rc = with_bound(dict(case=name, launches=n, max_abs_err=err, tol=tol,
                             ms=ms, plain_ms=pms), *work, "bf16")
        torch.cuda.empty_cache()
        print(f"[train-kernels] rowpad_conv_dw {name} table "
              f"{tuple(table.shape)} d_out {tuple(d_out.shape)}, {n} a "
              f"step: max_abs_err {err:.3g} (tol {tol:.3g}), {ms:.4f} ms vs "
              f"plain {pms:.3f} ms, bound {rc['bound_ms']:.4f} ms "
              f"({rc['bound_by']})")
        if not err <= tol:
            raise AssertionError(f"rowpad_conv_dw {name} disagrees")
        if not torch.equal(got, again):
            raise AssertionError(f"rowpad_conv_dw {name} differs between "
                                 f"two launches")
        return rc

    rec = {"rowpad_conv": sum_cases(
               [conv_case(*c) for c in conv_shapes("K4", stem_cin)]),
           "rowpad_conv_dw": sum_cases(
               [dw_case(*c) for c in conv_shapes("K5", stem_cin)])}
    for name in rec:
        print(f"[train-kernels] {name} launch-weighted: "
              f"{rec[name]['weighted_ms']:.3f} ms a step (bound "
              f"{rec[name]['weighted_bound_ms']:.3f} ms)")
    return rec


def check_pairwise(model, batch):
    """Phase 5: K6 against its plain version on the matched pairs that the
    next training step forms: the model's train-mode forward on the step's
    batch and weights (BN running statistics restored after it), and per
    head the boxes decoded at the target cells against their target boxes,
    batch * max_objs = 1000 pairs in one launch, as center_head_loss
    launches it.  Both versions round every operation alike, so the
    outputs must be equal.  Returns K6's record."""
    import torch
    from detzero_tpu_torch.models.detection.center_head import iou_pairs
    from detzero_tpu_torch.ops import iou_bev
    from detzero_tpu_torch.ops.box_ops import boxes3d_to_bev

    stats = {k: b.clone() for k, b in model.named_buffers()}
    was = model.training
    model.train()
    with torch.no_grad():
        preds, _ = model.network(*model.prepare(batch["points"],
                                                batch["points_valid"]))
        targets = model.targets(batch["gt_boxes"], batch["gt_classes"],
                                batch["gt_valid"])
        for k, b in model.named_buffers():
            b.copy_(stats[k])
    model.train(was)
    kw = dict(hw=model.bev_hw, feature_map_stride=model.feature_map_stride,
              voxel_size=model.voxel_size, pc_range=model.pc_range)
    overlap = (iou_bev.boxes_overlap_bev_pairwise,
               iou_bev.boxes_overlap_bev_pairwise_plain)
    iou = (iou_bev.boxes_iou_bev_pairwise,
           iou_bev.boxes_iou_bev_pairwise_plain)
    worst, ms, pms, iou_ms, iou_pms = 0.0, 0.0, 0.0, 0.0, 0.0
    n_bytes = n_ops = 0
    for hi, (pred, tgt) in enumerate(zip(preds, targets)):
        a, b = (boxes3d_to_bev(x.reshape(-1, 7))
                for x in iou_pairs(pred, tgt, **kw))
        for fn, plain in (overlap, iou):
            ref = plain(a, b)
            got = fn(a, b)
            torch.cuda.synchronize()
            worst = max(worst, max_abs(got, ref))
        ms += time_ms(lambda: overlap[0](a, b))
        pms += time_ms(lambda: overlap[1](a, b), iters=3)
        iou_ms += time_ms(lambda: iou[0](a, b))
        iou_pms += time_ms(lambda: iou[1](a, b), iters=3)
        n_over = int((overlap[0](a, b) > 0).sum())
        n_bytes += nbytes(a, b) + 4 * a.shape[0]
        n_ops += clip_ops(a, b, pairwise=True)
        print(f"[train-kernels] boxes_bev_pairwise head {hi}: {a.shape[0]} "
              f"pairs ({int(tgt['mask'].sum())} matched, {n_over} "
              f"overlapping)")
    print(f"[train-kernels] boxes_bev_pairwise, both heads, overlap + iou: "
          f"max_abs_err {worst:.3g} (must be 0); overlap (what the step "
          f"launches) {ms:.3f} ms vs plain {pms:.3f} ms, iou {iou_ms:.3f} "
          f"ms vs plain {iou_pms:.3f} ms")
    if worst != 0.0:
        raise AssertionError("boxes_bev_pairwise disagrees with its plain "
                             "version")
    return with_bound(dict(max_abs_err=worst, ms=ms, plain_ms=pms), n_bytes,
                      n_ops, "f32")


def timed_steps(tag, model, trainer, batch, device, want, timed=3):
    """`timed` counted training steps, each held to the launch counts
    `want` and to a finite loss and gradient norm: prints each step, the
    launches, the aux terms, ms/step, samples/s and peak memory, then the
    stage times of one more step.  Returns the last step's launches."""
    import torch

    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for i in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_counts()
        start.record()
        loss, aux, gnorm = trainer.step(batch)       # a counted step
        end.record()
        torch.cuda.synchronize()
        launches = read_counts()
        times.append(start.elapsed_time(end))
        if launches != want:
            raise AssertionError(f"{tag} step {i}: launch counts "
                                 f"{launches}, expected {want}")
        if not (torch.isfinite(loss) and torch.isfinite(gnorm)):
            raise AssertionError(f"{tag} step {i}: loss {float(loss)}, "
                                 f"gnorm {float(gnorm)}")
        print(f"[{tag}] step {i}: {times[-1]:.2f} ms, loss "
              f"{float(loss):.4f}, gnorm {float(gnorm):.4f}, lr "
              f"{trainer.optimizer.lr:.3g}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"[{tag}] launches in one step: {launches}")
    print(f"[{tag}] aux: " + ", ".join(f"{k} {float(v.mean()):.4f}"
                                       for k, v in aux.items()))
    ms = sum(times) / timed
    print(f"[{tag}] flagship batch {TRAIN_BATCH}, {timed} steps: {ms:.2f} "
          f"ms/step ({', '.join(f'{t:.2f}' for t in times)}), "
          f"{1000.0 * TRAIN_BATCH / ms:.3f} samples/s, peak memory "
          f"{peak:.2f} GiB")
    st = stage_times(lambda: trainer.step(batch), [model, trainer])
    print(f"[{tag}] stage ms: " + ", ".join(f"{k} {t:.2f}"
                                            for k, t in st.items()))
    return launches


def flagship_trainer(model, timed=3):
    from detzero_tpu_torch.core.optim import build_optimizer
    from detzero_tpu_torch.parallel.trainer import Trainer

    return Trainer(model, build_optimizer(FLAGSHIP_OPT, timed + 2, model))


def flagship_train_batch(device):
    pts, pv = entry_points(batch=TRAIN_BATCH)
    gt = make_gt(TRAIN_BATCH, FLAGSHIP_KW["max_objs"], 48, 60.0)
    return train_batch(pts, pv, gt, device)


def run_train(device):
    """Phase 5 and 6.  Returns (kernel records of phase 5, {kernel name:
    launches in the counted step}, the warm-up step's loss)."""
    import torch

    batch = flagship_train_batch(device)
    model = build_model(FLAGSHIP_CFG, FLAGSHIP_KW, torch.bfloat16, device)
    rec = check_train_kernels(model, batch, device)
    torch.cuda.empty_cache()

    trainer = flagship_trainer(model)
    warm = float(trainer.step(batch)[0])             # warm-up step
    torch.cuda.synchronize()
    rec["boxes_iou_bev_pairwise"] = check_pairwise(model, batch)
    torch.cuda.empty_cache()
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"stream_rowpad_feats": TRAIN_BATCH, "rowpad_conv": 39,
                 "rowpad_conv_dw": 20, "boxes_iou_bev_pairwise": 2,
                 "rowpad_nbr": NBR_LAUNCHES * TRAIN_BATCH})
    print(f"[train] warm-up step loss {warm:.6f}")
    return rec, timed_steps("train", model, trainer, batch, device,
                            want), warm


# the tiny training check's draws: points from RandomState(s), GT from
# RandomState(s + 1).  Draw 0 is tests/test_torch_train_step.py's batch;
# on draw 2 a ReLU region of the 2D backbone flips between the card and the
# CPU in float32 (PERF.md section 7)
TINY_TRAIN_DRAWS = (0, 2)


def tiny_train_batch(seed, device):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-6, 6, (TRAIN_BATCH, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (TRAIN_BATCH, 2048))
    gt = make_gt(TRAIN_BATCH, TINY_KW["max_objs"], 5, 5.5, seed=seed + 1)
    return train_batch(pts, np.ones(pts.shape[:2], bool), gt, device)


def grad_agreement(ref, got, rel=5e-2):
    """How far gradient leaves `got` lie from `ref` ({name: tensor}), each
    element against its leaf's bound rel * max(max|ref leaf|, 1): the share
    of all elements beyond it, the lowest share of one leaf's elements
    within it, the worst err/bound, the relative L2 distance of the whole
    gradient, and the ratio of the global norms got / ref."""
    out = n_all = 0
    min_share, worst, d2, r2, g2 = 1.0, 0.0, 0.0, 0.0, 0.0
    for k, r in ref.items():
        r, g = r.double().cpu(), got[k].double().cpu()
        err = (g - r).abs()
        bound = rel * max(float(r.abs().max()), 1.0)
        n_out = int((err > bound).sum())
        out, n_all = out + n_out, n_all + r.numel()
        min_share = min(min_share, 1.0 - n_out / r.numel())
        worst = max(worst, float(err.max()) / bound)
        d2 += float(((g - r) ** 2).sum())
        r2 += float((r ** 2).sum())
        g2 += float((g ** 2).sum())
    return dict(out_share=out / n_all, min_leaf_share=min_share,
                worst=worst, rel_l2=(d2 / r2) ** 0.5,
                norm_ratio=(g2 / r2) ** 0.5)


def check_tiny_train(device):
    """The training loss and its gradient on the tiny geometry at batch 2,
    the card (kernels) against the CPU (plain versions, float32), from the
    same weights, on each of TINY_TRAIN_DRAWS:
      * losses within 5e-2 * max(|ref|, 1), the bound of the tiny predict
        check, for the float32 and the bf16 model on the card;
      * the float32 model's gradient (K4 on float32 tables): at most 1e-4
        of all elements and 10% of any one leaf's beyond 5e-2 *
        max(|ref leaf|, 1), and the global norm within 1e-2.  At random
        init a ReLU region of the 2D backbone can flip under float32
        rounding and move a few hundred elements of a leaf past that
        bound; the CPU's own step does the same under a 1e-7 relative
        weight change, so the check counts elements instead of taking the
        worst one;
      * the bf16 model's gradient: the global norm within 25%.  bf16
        rounding alone leaves its direction uncorrelated with the float32
        gradient's (relative L2 distance about 1), so only its scale is
        held (PERF.md section 7).
    Prints each draw's readings."""
    import torch
    from detzero_tpu_torch.ops import iou_bev, rowpad_conv, rowpad_nbr

    cpu = build_model(TINY_TRAIN_CFG, TINY_KW, torch.float32, "cpu")
    weights = {k: v.clone() for k, v in cpu.state_dict().items()}
    card = {dtype: build_model(TINY_TRAIN_CFG, TINY_KW, dtype, device)
            for dtype in (torch.float32, torch.bfloat16)}
    for seed in TINY_TRAIN_DRAWS:
        runs = {}
        for name, model, dev in (("cpu", cpu, "cpu"),
                                 ("f32", card[torch.float32], device),
                                 ("bf16", card[torch.bfloat16], device)):
            model.load_state_dict(weights)
            model.zero_grad(set_to_none=True)
            reset_counts()
            loss, _ = model.loss(**tiny_train_batch(seed, dev))
            loss.backward()
            torch.cuda.synchronize()
            n = (rowpad_conv.CONV_LAUNCHES, rowpad_conv.DW_LAUNCHES,
                 iou_bev.PAIRWISE_LAUNCHES, rowpad_nbr.LAUNCHES)
            if name != "cpu" and n != (39, 20, 2,
                                       NBR_LAUNCHES * TRAIN_BATCH):
                raise AssertionError(f"tiny train draw {seed} {name}: K4, "
                                     f"K5, K6, K8 launches {n}")
            runs[name] = (float(loss.detach()), {
                k: p.grad for k, p in model.named_parameters()})
        ref = runs["cpu"][0]
        for name in ("f32", "bf16"):
            if not abs(runs[name][0] - ref) <= 5e-2 * max(abs(ref), 1.0):
                raise AssertionError(f"tiny train draw {seed}: {name} loss "
                                     f"{runs[name][0]}, CPU {ref}")
        f32 = grad_agreement(runs["cpu"][1], runs["f32"][1])
        bf16 = grad_agreement(runs["cpu"][1], runs["bf16"][1])
        print(f"[train] tiny draw {seed}, card vs CPU: loss CPU {ref:.5f}, "
              f"f32 {runs['f32'][0]:.5f}, bf16 {runs['bf16'][0]:.5f}; "
              f"gradient f32 " + ", ".join(f"{k} {v:.4g}"
                                          for k, v in f32.items())
              + "; bf16 " + ", ".join(f"{k} {v:.4g}"
                                      for k, v in bf16.items()))
        if not (f32["out_share"] <= 1e-4 and f32["min_leaf_share"] >= 0.9
                and abs(f32["norm_ratio"] - 1.0) <= 1e-2):
            raise AssertionError(f"tiny train draw {seed}: float32 "
                                 f"gradient {f32}")
        if not abs(bf16["norm_ratio"] - 1.0) <= 0.25:
            raise AssertionError(f"tiny train draw {seed}: bf16 gradient "
                                 f"norm ratio {bf16['norm_ratio']}")


def run_two_stage_predict(device):
    """Phase 7.  Returns {kernel name: launches in the counted frame}."""
    import torch

    pts, pv = entry_points()
    model = build_model(FLAGSHIP2_CFG, FLAGSHIP_KW, torch.bfloat16, device)
    p = torch.from_numpy(pts).to(device)
    v = torch.from_numpy(pv).to(device)
    for _ in range(2):                               # warm-up frames
        model.predict(p, v)
    torch.cuda.synchronize()

    reset_counts()
    out = model.predict(p, v)                        # the counted frame
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"[two-stage predict] launches in one frame: {launches}")
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"rowpad_conv_fused": 20, "boxes_iou_bev": 1,
                 "nms_walk": 1, "rowpad_nbr": NBR_LAUNCHES})
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    r = FLAGSHIP2_CFG["ROI_BUDGET"]
    shapes = {k: tuple(t.shape) for k, t in out.items()}
    if shapes != {"boxes": (1, r, 7), "scores": (1, r), "labels": (1, r),
                  "mask": (1, r)}:
        raise AssertionError(f"two-stage predict shapes {shapes}")
    for k, t in out.items():
        if t.is_floating_point() and not torch.isfinite(t).all():
            raise AssertionError(f"non-finite two-stage output {k}")
    n_kept = int(out["mask"].sum())
    sc = out["scores"][out["mask"]]
    if not (0 < n_kept and float(sc.min()) > 0 and float(sc.max()) <= 1):
        raise AssertionError(f"two-stage predict: {n_kept} kept, scores "
                             f"{sc}")
    print(f"[two-stage predict] outputs finite; boxes {shapes['boxes']}, "
          f"{n_kept} proposals kept, refined scores {float(sc.min()):.4f} "
          f"to {float(sc.max()):.4f}")

    torch.cuda.reset_peak_memory_stats(device)
    frames = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        model.predict(p, v)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / frames
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"[two-stage predict] flagship {frames} frames: {ms:.2f} ms/frame,"
          f" {1000.0 / ms:.3f} frames/s, peak memory {peak:.2f} GiB")
    st = stage_times(lambda: model.predict(p, v), [model], calls=3)
    print("[two-stage predict] stage ms: " + ", ".join(
        f"{k} {t:.2f}" for k, t in st.items()))
    return launches


def check_overlap(model, batch, device):
    """Phase 8: K7 against its plain version on the RoI targets' own inputs
    of the next training step, sample 0's 128 RoIs (the batch's train-mode
    forward on the step's weights, BN statistics restored) against its 500
    GT slots, as `assign_roi_targets` launches it; and on
    1000 x 1000 clustered boxes.  Both versions round every operation
    alike: 1e-5 * the largest area covers sin/cos differing in the last
    ulp.  Returns K7's record, timed and bounded at the path's shape."""
    import torch
    from detzero_tpu_torch.ops import iou_bev
    from detzero_tpu_torch.ops.box_ops import boxes3d_to_bev

    stats = {k: b.clone() for k, b in model.named_buffers()}
    was = model.training
    model.train()
    with torch.no_grad():
        _, roi = model.network(*model.prepare(batch["points"],
                                              batch["points_valid"]))
        for k, b in model.named_buffers():
            b.copy_(stats[k])
    model.train(was)
    path = (boxes3d_to_bev(roi["rois"][0]).contiguous(),
            boxes3d_to_bev(batch["gt_boxes"][0][:, :7]).contiguous())
    big = (clustered_boxes(device),) * 2
    rec = {}
    for name, (a, b) in (("path", path), ("1000x1000", big)):
        ref = iou_bev.boxes_overlap_bev_plain(a, b)
        got = iou_bev.boxes_overlap_bev(a, b)
        torch.cuda.synchronize()
        err = max_abs(got, ref)
        tol = 1e-5 * max(float(ref.max()), 1.0)
        ms = time_ms(lambda: iou_bev.boxes_overlap_bev(a, b))
        pms = time_ms(lambda: iou_bev.boxes_overlap_bev_plain(a, b), iters=3)
        rec[name] = with_bound(dict(max_abs_err=err, ms=ms, plain_ms=pms),
                               nbytes(a, b, got),
                               clip_ops(a, b), "f32")
        print(f"[two-stage train] boxes_overlap_bev {name} "
              f"{tuple(got.shape)} ({int((got > 0).sum())} overlapping "
              f"pairs): max_abs_err {err:.3g} (tol {tol:.3g}), {ms:.4f} ms "
              f"vs plain {pms:.3f} ms, bound {rec[name]['bound_ms']:.5f} ms "
              f"({rec[name]['bound_by']})")
        if not err <= tol:
            raise AssertionError(f"boxes_overlap_bev {name} disagrees with "
                                 f"its plain version")
    return dict(rec["path"], max_abs_err=max(r["max_abs_err"]
                                             for r in rec.values()),
                big=rec["1000x1000"])


def run_two_stage_train(device):
    """Phase 8.  Returns (K7's record, {kernel name: launches in the
    counted step})."""
    import torch

    batch = flagship_train_batch(device)
    # the RoI subsample's draws, from a seeded generator on the card
    batch["generator"] = torch.Generator(device=device).manual_seed(5)
    model = build_model(FLAGSHIP2_CFG, FLAGSHIP_KW, torch.bfloat16, device)
    trainer = flagship_trainer(model)
    trainer.step(batch)                              # warm-up step
    torch.cuda.synchronize()
    rec = check_overlap(model, batch, device)
    torch.cuda.empty_cache()
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"boxes_iou_bev": TRAIN_BATCH, "nms_walk": TRAIN_BATCH,
                 "rowpad_conv": 39, "rowpad_conv_dw": 20,
                 "boxes_iou_bev_pairwise": 2,
                 "boxes_overlap_bev": TRAIN_BATCH,
                 "rowpad_nbr": NBR_LAUNCHES * TRAIN_BATCH})
    return rec, timed_steps("two-stage train", model, trainer, batch,
                            device, want)


def roi_grad_shares(grads):
    """{leaf: share of its elements where grads["f32"] and grads["cpu"]
    differ by more than 1e-3 * max|CPU leaf| + 1e-6}."""
    share = {}
    for k, r in grads["cpu"].items():
        bound = 1e-3 * float(r.abs().max()) + 1e-6
        share[k] = float(((grads["f32"][k] - r).abs() > bound).sum()) \
            / r.numel()
    return share


def check_tiny_two_stage(device):
    """Phase 9: the tiny two-stage model, the card against the CPU from the
    same weights.
      * Predict (bf16 on the card; K2 always computes in bf16): the
        first-stage head outputs and the multi-scale tables within 5e-2 *
        max(|ref|, 1), the bound of the tiny predict check, and the RoI
        head on the CPU's own proposals and tables within the same bound.
        The proposals come from a top-k of the heatmaps, which bf16
        rounding reorders, so the card's own end-to-end boxes are held to
        be finite only.
      * The training loss at batch 2 in float32 on the card (K4 on float32
        tables; K3, the walk and K7 on the train-mode proposals), float32
        on both sides: the loss and each RoI term (roi_cls, roi_reg,
        roi_corner) within 1e-3 relative.  The RoI head's gradient there
        also carries the first stage's rounding (K4 and cuDNN against the
        CPU), amplified by its batch norms; its share of elements past the
        bound below is printed.
      * The RoI head, its targets (K7) and its loss alone, train mode, on
        the CPU's own proposals, BEV map and tables, where only the
        rounding of the head's own sums differs: every gradient leaf of the
        RoI head with at most 1e-3 of its elements beyond 1e-3 * max|CPU
        leaf| + 1e-6, the bound tests/test_torch_two_stage_train.py holds
        the port to against the reference (an element past it is a max-pool
        or ReLU decision flipped by rounding)."""
    import torch

    cpu = build_model(TINY2_CFG, TINY_KW, torch.float32, "cpu")
    gpu = build_model(TINY2_CFG, TINY_KW, torch.bfloat16, device)
    gpu.load_state_dict(cpu.state_dict())
    batch = tiny_train_batch(0, "cpu")
    p, v = batch["points"], batch["points_valid"]
    worst = 0.0

    def close(ref, got, what):
        nonlocal worst
        err = max_abs(got.cpu(), ref)
        tol = 5e-2 * max(float(ref.float().abs().max()), 1.0)
        worst = max(worst, err / tol)
        if not err <= tol:
            raise AssertionError(f"tiny two-stage {what}: {err} > {tol}")

    with torch.no_grad():
        outs = []
        for model, dev in ((cpu, "cpu"), (gpu, device)):
            out3d = model.backbone3d(*model.prepare(p[:1].to(dev),
                                                    v[:1].to(dev)))
            bev = model.backbone2d(out3d["spatial_features"].to(model.dtype))
            outs.append((out3d["multi_scale_3d_features"], bev,
                         model.center_head(bev)))
        (ms_c, bev_c, heads_c), (ms_g, _, heads_g) = outs
        for r, g in zip(heads_c, heads_g):
            for k in r:
                close(r[k], g[k], f"head output {k}")
        for name in ms_c:
            close(ms_c[name]["features"], ms_g[name]["features"], name)
        prop = cpu.proposals(heads_c)
        ref = cpu.refine(prop, bev_c, ms_c)
        got = gpu.refine(
            {k: t.to(device) for k, t in prop.items()},
            bev_c.to(device, torch.bfloat16),
            {n: {k: t.to(device) for k, t in lv.items()}
             for n, lv in ms_c.items()})
        for k in ("cls_logit", "reg_deltas"):
            close(ref[k], got[k], f"RoI head {k}")
        out = gpu.predict(p[:1].to(device), v[:1].to(device))
        if not all(bool(torch.isfinite(t.float()).all())
                   for t in out.values()):
            raise AssertionError("tiny two-stage predict: non-finite output")

    gb = batch["gt_boxes"].clone()
    gb[:, :4, :7] = ref["rois"][0, :4] + 0.05       # foreground RoIs
    batch["gt_boxes"] = gb
    draws = cpu.roi_draws(TRAIN_BATCH, torch.Generator().manual_seed(1))
    f32 = build_model(TINY2_CFG, TINY_KW, torch.float32, device)
    f32.load_state_dict(cpu.state_dict())
    runs, grads = {}, {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("f32", f32, device)):
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss, aux = model.loss(**{k: t.to(dev) for k, t in batch.items()},
                               roi_draws=tuple(d.to(dev) for d in draws))
        loss.backward()
        torch.cuda.synchronize()
        n = read_counts()
        if dev != "cpu" and (n["boxes_overlap_bev"], n["rowpad_conv"],
                             n["rowpad_nbr"]) \
                != (TRAIN_BATCH, 39, NBR_LAUNCHES * TRAIN_BATCH):
            raise AssertionError(f"tiny two-stage loss launches {n}")
        grads[name] = {k: q.grad.cpu() for k, q in model.named_parameters()
                       if k.startswith("roi_head.")}
        runs[name] = {"loss": loss.detach().cpu()}
        runs[name].update({k: t.detach().cpu() for k, t in aux.items()
                           if k.startswith("roi_")})
    rel = {k: float((runs["f32"][k] - r).abs().max()
                    / max(float(r.abs().max()), 1e-3))
           for k, r in runs["cpu"].items()}
    if sorted(rel) != ["loss", "roi_cls", "roi_corner", "roi_reg"] \
            or not max(rel.values()) <= 1e-3:
        raise AssertionError(f"tiny two-stage loss terms, card vs CPU: "
                             f"relative errors {rel}")
    full = roi_grad_shares(grads)

    for name, model, dev in (("cpu", cpu, "cpu"), ("f32", f32, device)):
        model.zero_grad(set_to_none=True)
        model.train()
        roi = model.refine({k: t.to(dev) for k, t in prop.items()},
                           bev_c.to(dev), {n: {k: t.to(dev)
                                               for k, t in lv.items()}
                                           for n, lv in ms_c.items()})
        loss, _ = model.roi_loss(roi, gb[:1].to(dev),
                                 batch["gt_valid"][:1].to(dev),
                                 tuple(d[:1].to(dev) for d in draws))
        loss.mean().backward()
        model.eval()
        grads[name] = {k: q.grad.cpu() for k, q in model.named_parameters()
                       if k.startswith("roi_head.")}
    alone = roi_grad_shares(grads)
    top = max(alone, key=alone.get)
    print(f"[two-stage tiny] card vs CPU: predict worst err/tol "
          f"{worst:.3f}; float32 loss {float(runs['f32']['loss']):.5f} (CPU "
          f"{float(runs['cpu']['loss']):.5f}), relative errors of the loss "
          f"and RoI terms {rel}; share of RoI head gradient elements past "
          f"the bound, largest over {len(alone)} leaves: whole loss "
          f"{max(full.values()):.3g}, RoI head alone {alone[top]:.3g} "
          f"({top})")
    if not alone[top] <= 1e-3:
        raise AssertionError(f"tiny two-stage RoI head gradient {top}: "
                             f"{alone[top]} of its elements beyond the bound")


def check_sliding(model, batch, device):
    """Phase 10: K9 against K4 and against its plain version (K4's in
    'subm') on the card, at the 'subm' shapes of the flagship training step
    (batch 2 stacked along the BEV-row axis): the stem (cin = the point
    features), and one conv of each level.  K9 sums one fmaf at a time and
    K4 on the tensor cores, so K9 is held to both the plain version and K4
    at K4's own 2e-2 * max|ref| on bf16 weights.  Returns K9's record."""
    import torch
    from detzero_tpu_torch.ops import rowpad_conv

    gen = torch.Generator(device=device).manual_seed(6)
    with torch.no_grad():
        rp_feats, plan = model.prepare(batch["points"],
                                       batch["points_valid"])
    nz0 = plan[0]["rp_zmask"].shape[1]
    shapes = [("stem L0", rp_feats, 0, rp_feats.shape[1] // nz0, 16)]
    for lv, c in enumerate((16, 32, 64, 128)):
        shapes.append((f"L{lv}", masked_table(plan[lv]["rp_zmask"], c, gen),
                       lv, c, c))
    cases = []
    for name, table, lv, cin, cout in shapes:
        zm = plan[lv]["rp_zmask"]
        w = (torch.randn((27, cin, cout), generator=gen, device=device)
             * (27 * cin) ** -0.5).bfloat16()
        kw = dict(nz=zm.shape[1], cin=cin, cout=cout)
        a = (table, plan[lv]["rp_nbr"], w, zm)
        got = rowpad_conv.rowpad_conv_sliding(*a, **kw)
        k4 = rowpad_conv.rowpad_conv(*a, **kw)
        ref = rowpad_conv.rowpad_conv_plain(*a, **kw)
        torch.cuda.synchronize()
        err, d4 = max_abs(got, ref), max_abs(got, k4)
        tol = 2e-2 * max(float(ref.abs().max()), 1e-3)
        del ref, k4
        ms = time_ms(lambda: rowpad_conv.rowpad_conv_sliding(*a, **kw))
        k4_ms = time_ms(lambda: rowpad_conv.rowpad_conv(*a, **kw))
        pms = time_ms(lambda: rowpad_conv.rowpad_conv_plain(*a, **kw),
                      iters=2, warmup=1)
        work = conv_work(a[1], zm, zm, kw["nz"], cin, cout, "subm", 1)
        rc = with_bound(dict(case=f"{name} {cin}->{cout}", max_abs_err=err,
                             tol=tol, k4_diff=d4, ms=ms, k4_ms=k4_ms,
                             plain_ms=pms), *work, "bf16")
        cases.append(rc)
        torch.cuda.empty_cache()
        print(f"[sliding] rowpad_conv_sliding {rc['case']} in "
              f"{tuple(table.shape)}: max_abs_err {err:.3g} (tol {tol:.3g}), "
              f"max abs diff from K4 {d4:.3g}, {ms:.3f} ms vs K4 {k4_ms:.3f} "
              f"ms vs plain {pms:.3f} ms, bound {rc['bound_ms']:.4f} ms "
              f"({rc['bound_by']})")
        if not (err <= tol and d4 <= tol):
            raise AssertionError(f"rowpad_conv_sliding {name} disagrees")
    rec = sum_cases(cases)
    rec["k4_diff"] = max(c["k4_diff"] for c in cases)
    return rec


def run_sliding_train(device, warm_ref):
    """Phases 10 and 11: K9's checks, then phase 6's flagship step with
    `rowpad_conv.USE_SLIDING` on fresh weights from the same seed, the flag
    restored after it; its warm-up loss within 1e-3 relative of phase 6's
    `warm_ref`.  Returns (K9's record, {kernel name: launches in the counted
    step})."""
    import torch
    from detzero_tpu_torch.ops import rowpad_conv

    batch = flagship_train_batch(device)
    model = build_model(FLAGSHIP_CFG, FLAGSHIP_KW, torch.bfloat16, device)
    rec = check_sliding(model, batch, device)
    torch.cuda.empty_cache()
    was = rowpad_conv.USE_SLIDING
    rowpad_conv.USE_SLIDING = True
    try:
        trainer = flagship_trainer(model)
        warm = float(trainer.step(batch)[0])         # warm-up step
        rel = abs(warm - warm_ref) / abs(warm_ref)
        print(f"[sliding train] warm-up step loss {warm:.6f}, phase 6's "
              f"{warm_ref:.6f}: relative difference {rel:.3g} (bound 1e-3)")
        if not rel <= 1e-3:
            raise AssertionError("sliding train: warm-up loss differs from "
                                 "phase 6's")
        torch.cuda.empty_cache()
        want = dict.fromkeys(COUNTERS, 0)
        want.update({"stream_rowpad_feats": TRAIN_BATCH,
                     "rowpad_conv_sliding": 17, "rowpad_conv": 22,
                     "rowpad_conv_dw": 20, "boxes_iou_bev_pairwise": 2,
                     "rowpad_nbr": NBR_LAUNCHES * TRAIN_BATCH})
        launches = timed_steps("sliding train", model, trainer, batch,
                               device, want)
    finally:
        rowpad_conv.USE_SLIDING = was
    return rec, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from detzero_tpu_torch import _build

    # 1. device
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-2:]
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {' / '.join(nvcc)}")
    try:
        import triton
        print(f"[device] triton {triton.__version__}")
    except ImportError:
        print("[device] triton not installed")
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {smi}; {torch.cuda.get_device_name(0)}, capability "
          f"{cap[0]}.{cap[1]}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.time()
    so = _build.build()
    _build.lib()
    print(f"[build] {so.relative_to(_build.BUILD_ROOT.parent.parent)} in "
          f"{time.time() - t0:.1f} s")
    print_ptxas((so.parent / "ptxas.log").read_text())

    # 3. kernels at the flagship path's shapes
    pts, pv = entry_points()
    model = build_model(FLAGSHIP_CFG, FLAGSHIP_KW, torch.bfloat16, device)
    rec = check_kernels(model, pts, pv, device)
    del model
    torch.cuda.empty_cache()

    # 4. flagship predict, then the tiny reference check
    by_path = {"predict": run_predict(device)}
    check_tiny(device)
    torch.cuda.empty_cache()

    # 5. and 6. training kernels, the flagship train step, the tiny check
    train_rec, by_path["train_step"], warm = run_train(device)
    rec.update(train_rec)
    torch.cuda.empty_cache()
    check_tiny_train(device)
    torch.cuda.empty_cache()

    # 7. to 9. the two-stage model: predict, the training step with K7, and
    # the tiny check
    by_path["two_stage_predict"] = run_two_stage_predict(device)
    torch.cuda.empty_cache()
    rec["boxes_overlap_bev"], by_path["two_stage_train_step"] = \
        run_two_stage_train(device)
    torch.cuda.empty_cache()
    check_tiny_two_stage(device)
    torch.cuda.empty_cache()

    # 10. and 11. the sliding conv K9 at the step's shapes, then phase 6's
    # step with it
    rec["rowpad_conv_sliding"], by_path["sliding_train_step"] = \
        run_sliding_train(device, warm)

    # result lines
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = rec[name]
        counts = {path: c[name] for path, c in by_path.items() if c[name]}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(counts.values()),
                        "launches_by_path": counts,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms")})
        if "weighted_ms" in r:
            kernels[-1]["weighted_ms"] = r["weighted_ms"]
        # K3 on the frame's NMS input, K7 on 1000 x 1000 clustered boxes
        for key in ("frame", "big"):
            if key in r:
                kernels[-1][key] = {k: r[key][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms")}
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

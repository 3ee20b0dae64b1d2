#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detzero_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and the exit code is 1:
  1. device: versions, card name and power limit (no CUDA -> exit 1);
  2. build: compile detzero_tpu_torch/csrc/*.cu from this checkout, and
     the native sweep loader (detzero_tpu_torch/native/loader.cpp, g++)
     beside it;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes of the flagship path, with stated tolerances
     and CUDA-event times (K2 at every distinct conv of the frame, with
     its launches there and the launch-weighted ms a frame); K8 (the plan's
     neighbour-rank maps) on all 10 maps of the flagship plan in its one
     launch, equal on every element to the plain maps and to its
     `torch.searchsorted` yardstick; K3 on 1000 x 1000 clustered boxes and
     on the frame's own NMS input (the decoded top-k boxes); K10 (rotated
     NMS: the mask epilogue of K3's tile kernel and the one-warp walk) on
     both, its mask words equal to the pack of K3's matrix and its keep
     mask to the plain walk's, the mask kernel, the walk and the whole
     each timed beside its bound;
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
 10. sliding kernel: K9 (rowpad_conv_sliding) against K4 (equal bit for
     bit) and against the plain version at the flagship training step's
     'subm' shapes (stem, L0, L1, L2, L3), each with K9's time over K4's;
 11. sliding train: phase 6's step with `rowpad_conv.USE_SLIDING` set for
     this phase only, on fresh weights from the same seed: launch counts
     (K9 for the 17 'subm' forward convs), its warm-up loss against phase
     6's, ms/step over 3 timed steps after the warm-up step, stage times,
     peak memory;
 12. train_det: the detection training entry point
     (`detzero_tpu_torch.tools.train_det.main`) on a Waymo-layout tree
     written to a temporary directory: one sequence of 8 frames of 160,000
     points (x, y, z, intensity, elongation, NLZ -1) from the port's
     SyntheticWaymoDataset.generate_scene with 48 objects, seen from an
     ego that moves 1 m a frame, the info pkl with 9-wide GT boxes (the
     objects' velocities from the generator's motion), a GT database of
     the crops, and a yaml on configs/det_model_cfgs/centerpoint_5sweeps
     .yaml (5 sweeps, 200,000-point budget, capacities 150k/75k/40k/20k,
     batch 2, adam_onecycle, all four augmentors, the GT sampler seeded;
     the sweeps read by the native reader).  The loader alone over one epoch (4 batches); on its
     first batch K1 at F = 6 and the stem conv 6 -> 16 of K4 and K5
     against their plain versions, and the
     pillars kept at each level against the capacities; then main()
     (one loader thread, so that the seeded draws and the checkpoint
     phase 13 reads are the same in every run) to step 4, again to step 6 (it resumes at 4), and to step 8 under
     torch.profiler: the launches of every run (the one-stage step's,
     each step), finite metrics.jsonl lines for steps 1-6, the newest
     checkpoint equal to the live model, fit's ms/step over the resumed
     steps, its idle share, peak memory, checkpoint bytes and save ms;
 13. test_det and tracking, in phase 12's tree on its newest checkpoint
     (the tree's 8 frames as the val split): `detzero_tpu_torch.tools
     .test_det.main` with --save_to_file over all 8 frames through the
     native sweep reader (K1 1, K2 20, K8 1, K10 1 a sample, and the
     reader's sample count equal to the frames loaded), frames/s from
     data, the loader's wait and predict's ms a frame, the evaluation
     table; the loader alone, native against numpy, in ms a frame; then
     with TTA on 2 frames (15 variants a frame, 30 samples; the same
     launches a sample) and WBF's ms a frame; WBF "members" on the first
     TTA frame's boxes, class by class, on the card against the CPU
     (equal clusters and scores, boxes within 1e-4, one K7 launch a class
     of more than 32 boxes); the evaluator on the tree's own GT offered as
     detections (AP 1.0 at L1 and L2); `run_track` and `eval_track` on
     test_det's result.pkl (every box may start a track and every track
     is kept, TRACK_SET; at least one track) and on a box-only segment of
     200 frames of the generator's 48 objects (the tracker's own config;
     at least 24 tracks): tracks, frames/s, recall, precision, MOTA,
     MOTP; no kernel launched;
 14. refining from tracks: 4 sequences of 20 frames (160,000 points, 48
     objects; SyntheticWaymoDataset seeds 0-3, posed as phase 12 poses
     them) written to a temporary tree; the tracker on their GT offered
     as detections (tracks, frames/s); `daemon.prepare_object_data` with
     the GT (ms a frame; the native cropper's frame count must be all 80)
     and `generate_iou_gt`, the per-class pickles and Vehicle's record
     cache (`build_record_cache`: ms, bytes); GRM, PRM and CRM at the
     width of configs/ref_model_cfgs/vehicle_{grm,prm,crm}.yaml on seeded
     weights, forward and decode of one batch of the Vehicle records on
     the card against the CPU (float32, within 1e-4 of scale, all finite,
     the padded PRM queries included); `train_refine.main` for each yaml
     at its batch to step 6 (finite losses, ms/step over steps 3-6, peak
     memory, checkpoint bytes), then to step 8 resumed under
     torch.profiler (idle share); `test_refine.main` for each with
     --save_to_file, and under TTA for GRM and PRM (tracks/s, recall at
     IoU 0.7 input -> output, printed); no kernel launched over the whole
     phase, which must end within 120 s;
 15. the offboard pipeline from raw records, on phase 12's checkpoint and
     phase 14's Vehicle refiners (phases 12-15 share one temporary root):
     2 sequences x 10 frames written as <seq>_with_camera_labels.tfrecord
     through the port's protobuf codec (SyntheticWaymoDataset scenes of
     160,000 points and 48 objects, posed as phase 12 poses them,
     projected into a 64 x 2650 TOP range image of two returns, the beams
     at the quantiles of the scene's inclinations; labels, pose, context,
     timestamp); `create_waymo_infos.main` --stage infos then gt_database
     (s, ms a frame), every record read again with its CRCs verified and
     decoded (ms a frame, at least 100,000 points a frame, equal to the
     .npy); `test_det.main` on that tree with phase 12's checkpoint (all
     20 frames, the native reader; K1 1, K2 20, K8 1, K10 1 a sample,
     exact; frames/s); `run_offboard.main` on its result.pkl with the
     preprocessed tree as points root and the three Vehicle refiners on
     the card (their forward's inputs on the card, the first run of each
     kind profiled: its kernels on the card; no kernel of the port;
     StageTimer's stage seconds; 20 finite final frames, 10 a sequence);
     the infos' GT offered as detections through `run_offboard` (no
     refiners) and `detzero_eval --metric detection` against that GT
     posed into the global frame: Vehicle AP_L2 at least 0.9; a
     submission .bin of test_det's detections keyed by the infos'
     context names and timestamps, decoded back equal (bytes printed);
     the phase must end within 150 s.  Its test_det launches are the path
     `OB` of the kernels line;
 16. data parallelism on the one card, on phase 12's tree and checkpoint
     (NCCL puts no two ranks on one card, so the 2-rank runs join a gloo
     group on CUDA tensors, both on cuda:0): train_det to 3 steps with no
     process group and again as world size 1 of an NCCL group, cuDNN
     deterministic in both: metrics and checkpoint equal bit for bit;
     then 2 spawned gloo ranks (one process each): the tiny float32
     model, 2 ranks x 1 sample against one process x 2 samples on the
     card (loss within 1e-5 relative, gradient under the tiny training
     check's rule, BN statistics within 1e-5); train_det at the
     flagship's width, 2 ranks x BATCH_SIZE_PER_DEVICE, parameters,
     optimizer state and BN buffers compared across the ranks bit for bit
     after each of 3 steps, then resumed to step 5 under torch.profiler
     (ms/step a rank, peak memory a rank, each rank's idle share and the
     card's over the union of both ranks' kernels); test_det
     --data_parallel on phase 12's checkpoint, its result.pkl against
     phase 13's (the same frames in order, as many boxes, the same names,
     boxes and scores within 1e-4); launches held to the one-stage step's
     a step and test_det's a sample on each rank; within 300 s.  The
     2-rank runs' launches, summed over the ranks, are the path `DP`;
 17. the synthetic quality ladder (DET -> +TRK -> +GRM/PRM -> +CRM) in a
     temporary root of its own: `train_det.main` on configs/det_model_cfgs/
     centerpoint_synthetic_v3.yaml (its full width: 512 x 512 x 40 grid,
     20,000 points, 128 pillars a row, batch 1) to LADDER_DET_STEPS
     steps, the last LADDER_PROFILED_STEPS resumed under torch.profiler
     (ms/step after the warm-up, idle share, peak memory; launches a step
     exact); then detzero_tpu_torch/tools/run_synthetic_ladder.sh's recipe,
     `ladder_synthetic.run_recipe`, at its cut depth: records of 2
     train-seed sequences (records a class; some record's iou_gt finite
     and matched to GT), `train_refine.main` at configs/ref_model_cfgs/
     synthetic_{grm,prm}.yaml a class at a time (a class with no records,
     or whose tracks train_refine refuses as unable to fill one batch, is
     not trained, and printed), the relabel (some iou_gt must change),
     then CRM, the ladder on 2 val-seed sequences (seed 1234): the 4-row
     table, every entry finite in [0, 1], run_det's frames/s, the
     tracker's and refiners' seconds; launches a sample of both run_det
     calls exact; then the trained detector's heads on 2 val frames, the
     card against the CPU (both float32, K2 in bf16 on the card) within
     LADDER_CPU_TOL * max(|ref|, 1), and `iou3d.boxes_giou3d` on 1000 x
     1000 clustered boxes on the card against itself on K7's plain
     version (1e-4), `iou3d.boxes_iou_bev` (K3) against the reference's
     formula on K7's overlap (1e-6); within
     LADDER_PHASE_S.  Its launches are the path `LD`.
Every counted path also counts K8: one launch a sample (the plan's 10
maps).  Phase 2 prints, for every kernel, ptxas's registers, stack frame
and spills, and fails unless the IoU matrix kernel (the mask instance by
name), the neighbour-map kernel, K10's walk and the stream VFE kernel have
neither a stack frame nor spills.  The JSON record of K10 (`nms_walk`)
lists both of its sources and carries the mask's, the walk's and the
clustered boxes' numbers beside the frame's.
Per-stage times are CUDA events that the model's and the trainer's
`stage_hook` records at their own stage boundaries.  Kernel times are CUDA
events around calls queued behind a spin kernel (`time_ms`), so they read
the card's time even where a wrapper's host cost outlasts its kernel.
The line before the card's line carries every kernel's numbers as JSON:
launches summed over the counted paths, each path's own in
`launches_by_path`; `bound_ms`, the least time the card could take for the
timed work (the larger of its bytes, each input read once and each output
written once, over 3.35 TB/s, and its operations over the card's peak for
their type, counted from this run's inputs; for the row-pad convs only the
input values of occupied sites that some occupied output reads,
`conv_work`), and `bound_by`; K2, K4 and K5 also carry `weighted_ms`, the
sum over their shapes of kernel ms times launches a frame (K2) or a
training step (K4, K5); `library_ms`:
for K8 its yardstick, `torch.searchsorted` over the target rows plus the
found test; for K1 a `scatter_reduce_` mean into a zeroed table; null for
the others, since no single PyTorch call computes a sparse row-pad conv,
its weight gradient, a rotated-box overlap or the greedy walk.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

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
    # K10: the walk and K3's tile kernel with the mask epilogue
    "nms_walk": ("detzero_tpu_torch/csrc/nms_walk.cu",
                 "detzero_tpu/ops/pallas_iou.py:284",
                 "detzero_tpu_torch/csrc/iou_bev.cu"),
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
# kernels whose ptxas report must show no stack frame and no spills: the
# IoU tile kernel (every epilogue, the mask's by name), the neighbour maps,
# K10's walk and the stream VFE
NO_STACK_KERNELS = ("iou_bev_matrix_kernel", "iou_bev_matrix_kernelILi2E",
                    "rowpad_nbr_maps_kernel", "nms_walk_bits_kernel",
                    "stream_vfe_tile_kernel")
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
# (4) per pair; with the mask epilogue (K10), those 4 and the compare with
# the threshold per pair of the upper triangle.
CLIP_OPS = dict(box=75, edge_test=24, vertex=7, crossing=10, area_vertex=4,
                area=2, iou=4, threshold=1)


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


def clip_ops(a, b, pairwise=False, iou=False, upper=False):
    """CLIP_OPS summed over these BEV boxes (N, 5) x (M, 5) (or N matched
    pairs): the cull's side tests at the edges it tests
    (`iou_bev._clip_class`), and for the pairs it cannot tell the live
    vertices and crossings at each edge that the plain clip traces on these
    inputs.  `upper`: one box set against itself through the mask
    epilogue, only the pairs j > i, each with the IoU and its compare."""
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
    if upper:
        per_pair = torch.triu(per_pair + c["iou"] + c["threshold"],
                              diagonal=1)
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


def vfe_scatter_mean(payload, lane, z, wstart, *, nz, ny, row_budget,
                     out_dtype):
    """K1's yardstick: a function that computes K1's per-voxel means with
    one `scatter_reduce_(..., "mean", include_self=False)` of the in-window
    points' features into a zeroed row-pad table (f32, its zeroing
    included).  The flat indices, ((row * nz + z) * F + c) * B + lane, are
    set-up and made here once."""
    import torch

    b, f = row_budget, payload.shape[1] - 1
    t = torch.arange(payload.shape[0], device=payload.device)
    row = torch.searchsorted(wstart.long(), t, right=True) - 1
    ok = (t < wstart[ny]) & (lane >= 0) & (lane < b) & (z >= 0) & (z < nz)
    base = ((row * nz + z.long()) * f * b + lane.long())[ok]
    idx = (base[:, None] + torch.arange(f, device=payload.device) * b)
    idx, vals = idx.reshape(-1), payload[ok, :f].float().reshape(-1)
    n = ny * nz * f * b
    return lambda: torch.zeros(n, device=payload.device).scatter_reduce_(
        0, idx, vals, "mean", include_self=False).view(ny, nz * f, b)


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
    from detzero_tpu_torch.ops import iou_bev, nms, rowpad_conv

    rec = {}
    gen = torch.Generator(device=device).manual_seed(1)
    p = torch.from_numpy(pts[0]).to(device)
    v = torch.from_numpy(pv[0]).to(device)
    table = model.build_table(p, v)
    plan = model.build_plan(table)
    nz = model.grid_zyx[0]
    rec["stream_rowpad_feats"], rp_feats = check_vfe(model, table, "kernels")

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

    # K3 on this frame's own NMS input (its IoU epilogue, kept as K3 and
    # K7's check; NMS itself takes the mask epilogue), then K10 there and
    # on the clustered boxes
    boxes_f, valid_f, thresh_f = frame_nms_input(model, p, v)
    rec["boxes_iou_bev"]["frame"] = check_iou_frame(boxes_f)
    rec["nms_walk"] = check_nms(boxes_f, valid_f, thresh_f,
                                "the frame's NMS input")
    valid = torch.ones(1000, dtype=torch.bool, device=device)
    valid[::17] = False
    rec["nms_walk"]["clustered"] = check_nms(boxes, valid, 0.7,
                                             "1000 clustered boxes")
    return rec


def check_vfe(model, table, tag):
    """K1 against its plain version (and its scatter_reduce_ yardstick) on
    one sample's pillar table.  Returns (record, K1's bf16 table)."""
    import torch
    from detzero_tpu_torch.ops import stream_vfe

    s = table["stream"]
    kw = dict(nz=model.grid_zyx[0], ny=model.grid_zyx[1],
              row_budget=model.row_budget, out_dtype=torch.bfloat16)
    args = (s["payload"], s["lane"], s["z"], s["wstart"])
    f = args[0].shape[1] - 1
    # K1: bf16 means from f32 sums; the sums agree to f32 rounding, so the
    # stored means agree to one bf16 ulp: tolerance 2^-7 * max|ref|
    ref = stream_vfe.stream_rowpad_feats_plain(*args, **kw)
    got = stream_vfe.stream_rowpad_feats(*args, **kw)
    torch.cuda.synchronize()
    err, tol = max_abs(got, ref), 2 ** -7 * float(ref.float().abs().max())
    ms = time_ms(lambda: stream_vfe.stream_rowpad_feats(*args, **kw))
    pms = time_ms(lambda: stream_vfe.stream_rowpad_feats_plain(*args, **kw),
                  iters=3)
    print(f"[{tag}] stream_rowpad_feats F={f} {tuple(got.shape)}: "
          f"max_abs_err {err:.3g} (tol {tol:.3g}), {ms:.3f} ms vs plain "
          f"{pms:.3f} ms")
    if not err <= tol:
        raise AssertionError("stream_rowpad_feats disagrees with its plain "
                             "version")
    # K1's yardstick: the same means by one scatter_reduce_ into a zeroed
    # table, held to the plain version at K1's tolerance
    lib_fn = vfe_scatter_mean(*args, **kw)
    lib_err = max_abs(lib_fn(), ref)
    lms = time_ms(lib_fn)
    print(f"[{tag}] stream_rowpad_feats yardstick scatter_reduce_ mean: "
          f"max_abs_err {lib_err:.3g} (tol {tol:.3g}), {lms:.3f} ms")
    if not lib_err <= tol:
        raise AssertionError("scatter_reduce_ mean disagrees with "
                             "stream_rowpad_feats' plain version")
    # bytes: the stream read once, the table written once; operations: one
    # add per payload element, one divide per output element (f32)
    return with_bound(
        dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms),
        nbytes(*args, got), args[0].numel() + got.numel(), "f32"), got


def frame_nms_input(model, p, v):
    """The BEV boxes (k, 5), valid mask and threshold that one predict of
    (p, v) hands to K10 (`nms.nms_bev`: the decoded top-k boxes of both
    heads, k <= NMS_PRE_MAXSIZE 1024), recorded by wrapping
    `nms.nms_keep_mask` for this one call.  Score threshold 0, so that the
    walk has valid boxes at random weights."""
    from detzero_tpu_torch.ops import nms

    seen = {}
    keep_fn = nms.nms_keep_mask

    def keep_rec(bev, valid, thresh):
        seen.update(boxes=bev.clone(), valid=valid.clone(), thresh=thresh)
        return keep_fn(bev, valid, thresh)

    nms.nms_keep_mask = keep_rec
    try:
        model.predict(p[None], v[None], score_thresh=0.0)
    finally:
        nms.nms_keep_mask = keep_fn
    return seen["boxes"], seen["valid"], seen["thresh"]


def check_iou_frame(boxes):
    """K3 on the frame's NMS boxes against its plain version (1e-5
    absolute, as on the clustered boxes).  Returns the record, timed and
    bounded there."""
    import torch
    from detzero_tpu_torch.ops import iou_bev

    ref = iou_bev.boxes_iou_bev_plain(boxes, boxes)
    got = iou_bev.boxes_iou_bev(boxes, boxes)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    ms = time_ms(lambda: iou_bev.boxes_iou_bev(boxes, boxes))
    pms = time_ms(lambda: iou_bev.boxes_iou_bev_plain(boxes, boxes), iters=3)
    rc = with_bound(dict(max_abs_err=err, ms=ms, plain_ms=pms),
                    nbytes(boxes, boxes, got),
                    clip_ops(boxes, boxes, iou=True), "f32")
    n_clip = int((iou_bev.clip_class_plain(boxes, boxes)
                  == iou_bev.CLIP_NEEDED).sum())
    print(f"[kernels] boxes_iou_bev on the frame's NMS input "
          f"{tuple(got.shape)} ({n_clip} pairs need the clip): max_abs_err "
          f"{err:.3g} (tol 1e-05), {ms:.4f} ms vs plain {pms:.3f} ms, bound "
          f"{rc['bound_ms']:.5f} ms ({rc['bound_by']})")
    if not err <= 1e-5:
        raise AssertionError("boxes_iou_bev on the frame's NMS input "
                             "disagrees with its plain version")
    return rc


def check_nms(boxes, valid, thresh, what):
    """K10 on score-sorted BEV boxes (k, 5): the mask kernel's words equal
    the pack of K3's own matrix bit for bit (`nms_mask_plain`); the keep
    mask of `nms_keep_mask` (boxes, mask, walk) equal to the plain walk's
    on the plain matrix, and `nms_walk` on K3's float matrix (torch's
    pack, the walk kernel) equal to the plain walk's on it.  Times the
    mask kernel, the walk and the whole, each beside its bound: bytes the
    boxes, the mask written and read, valid and keep; operations the clip
    work of the upper triangle (`clip_ops(upper=True)`) and the walk's
    chain steps and the kept rows' word ORs.  max_abs_err counts the keep
    entries that differ."""
    import torch
    from detzero_tpu_torch.ops import iou_bev, nms

    k = boxes.shape[0]
    iou = iou_bev.boxes_iou_bev(boxes, boxes)
    ref_iou = iou_bev.boxes_iou_bev_plain(boxes, boxes)
    words = nms.nms_mask(boxes, thresh)
    keep = nms.nms_keep_mask(boxes, valid, thresh)
    keep_f = nms.nms_walk(iou, valid, thresh)
    torch.cuda.synchronize()
    bad_words = int((words != nms.nms_mask_plain(iou, thresh)).sum())
    diff = int((keep != nms.nms_walk_plain(ref_iou, valid, thresh)).sum())
    diff_f = int((keep_f != nms.nms_walk_plain(iou, valid, thresh)).sum())
    ms_mask = time_ms(lambda: nms.nms_mask(boxes, thresh))
    ms_walk = time_ms(lambda: nms.nms_walk_bits(words, valid))
    ms = time_ms(lambda: nms.nms_keep_mask(boxes, valid, thresh))
    pms = time_ms(lambda: nms.nms_keep_mask_plain(boxes, valid, thresh),
                  iters=2, warmup=1)
    n_kept = int(keep.sum())
    mask_bytes = nbytes(boxes[:, :5], words)
    walk_bytes = nbytes(words, valid, keep)
    mask_ops = clip_ops(boxes, boxes, upper=True)
    walk_ops = k + n_kept * words.shape[1]
    rc = with_bound(dict(max_abs_err=float(diff), ms=ms, plain_ms=pms),
                    mask_bytes + walk_bytes, mask_ops + walk_ops, "f32")
    rc["mask"] = with_bound(dict(ms=ms_mask), mask_bytes, mask_ops, "f32")
    rc["walk"] = with_bound(dict(ms=ms_walk), walk_bytes, walk_ops, "f32")
    print(f"[kernels] nms_keep_mask on {what} (k={k}, {int(valid.sum())} "
          f"valid, {n_kept} kept at {thresh}): mask words differ from the "
          f"pack of K3's matrix at {bad_words}, keep masks from the plain "
          f"walk's at {diff}, the float walk's at {diff_f} (all must be 0); "
          f"{ms:.4f} ms (bound {rc['bound_ms']:.5f}, {rc['bound_by']}) vs "
          f"plain {pms:.3f} ms; mask {ms_mask:.4f} ms (bound "
          f"{rc['mask']['bound_ms']:.5f}, {rc['mask']['bound_by']}), walk "
          f"{ms_walk:.4f} ms (bound {rc['walk']['bound_ms']:.5f}, "
          f"{rc['walk']['bound_by']})")
    if bad_words or diff or diff_f:
        raise AssertionError(f"nms_keep_mask on {what} disagrees with its "
                             f"plain version")
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
                 "nms_walk": 1, "rowpad_nbr": NBR_LAUNCHES})
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


def check_train_kernels(model, batch, device, stem_only=False, tag=None):
    """Phase 5: K4 and K5 against their plain versions on the card, at every
    distinct conv of the flagship training step (the stem alone with
    `stem_only`): the batch's tables and maps stacked along the BEV-row
    axis, as CenterPoint.loss runs them.  Returns {name: record}."""
    tag = tag or "train-kernels"
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
        print(f"[{tag}] rowpad_conv {name} in {tuple(table.shape)} "
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
        print(f"[{tag}] rowpad_conv_dw {name} table "
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

    n = 1 if stem_only else None
    rec = {"rowpad_conv": sum_cases(
               [conv_case(*c) for c in conv_shapes("K4", stem_cin)[:n]]),
           "rowpad_conv_dw": sum_cases(
               [dw_case(*c) for c in conv_shapes("K5", stem_cin)[:n]])}
    for name in rec:
        print(f"[{tag}] {name} launch-weighted: "
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
    # the degenerate pairs: zero-size boxes (what center_head pairs at
    # masked slots), identical boxes, boxes sharing an edge or a corner
    a, b = degenerate_pairs(a.device)
    for fn, plain in (overlap, iou):
        got, ref = fn(a, b), plain(a, b)
        torch.cuda.synchronize()
        worst = max(worst, max_abs(got, ref))
    print(f"[train-kernels] boxes_bev_pairwise, {a.shape[0]} degenerate "
          f"pairs checked too")
    print(f"[train-kernels] boxes_bev_pairwise, both heads, overlap + iou: "
          f"max_abs_err {worst:.3g} (must be 0); overlap (what the step "
          f"launches) {ms:.3f} ms vs plain {pms:.3f} ms, iou {iou_ms:.3f} "
          f"ms vs plain {iou_pms:.3f} ms")
    if worst != 0.0:
        raise AssertionError("boxes_bev_pairwise disagrees with its plain "
                             "version")
    return with_bound(dict(max_abs_err=worst, ms=ms, plain_ms=pms), n_bytes,
                      n_ops, "f32")


def degenerate_pairs(device, n=32, seed=8):
    """8 x n matched BEV pairs (N, 5) x (N, 5): zero-size boxes against
    zero-size and real ones (both orders), identical boxes, a box against
    its copy shifted by its length along its heading (a shared edge) and
    also by its width across it (a shared corner), and a zero-width box
    against a real one (both orders)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    a = torch.rand((n, 5), generator=g) * torch.tensor(
        [16.0, 16.0, 4.0, 4.0, 6.28]) + torch.tensor([-8, -8, 0.5, 0.5, -3.14])
    b = a + torch.randn((n, 5), generator=g) * 0.3
    b[:, 2:4] = b[:, 2:4].abs() + 0.1
    zero = torch.zeros_like(a)
    line = a.clone()
    line[:, 2] = 0.0
    h = a[:, 4]
    edge = a.clone()
    edge[:, :2] += a[:, 2:3] * torch.stack([torch.cos(h), torch.sin(h)], 1)
    corner = edge.clone()
    corner[:, :2] += a[:, 3:4] * torch.stack([-torch.sin(h), torch.cos(h)], 1)
    return (torch.cat([zero, zero, a, a, a, a, line, a]).to(device),
            torch.cat([zero, b, zero, a, edge, corner, a, line]).to(device))


def timed_steps(tag, model, trainer, batch, device, want, timed=3):
    """`timed` counted training steps, each held to the launch counts
    `want` and to a finite loss and gradient norm: prints each step, the
    launches, the aux terms, ms/step, samples/s and peak memory, then the
    stage times of one more step.  Returns (the last step's launches,
    ms/step)."""
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
    return launches, ms


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
    launches in the counted step}, the warm-up step's loss, ms/step)."""
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
    print(f"[train] warm-up step loss {warm:.6f}")
    launches, step_ms = timed_steps("train", model, trainer, batch, device,
                                    step_launches())
    return rec, launches, warm, step_ms


def step_launches():
    """{kernel name: launches} of one one-stage training step at batch
    TRAIN_BATCH: K1 and K8 once a sample, the 20 forward convs and 19
    input gradients of K4, the 20 weight gradients of K5, K6 once a
    head."""
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"stream_rowpad_feats": TRAIN_BATCH, "rowpad_conv": 39,
                 "rowpad_conv_dw": 20, "boxes_iou_bev_pairwise": 2,
                 "rowpad_nbr": NBR_LAUNCHES * TRAIN_BATCH})
    return want


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
    want.update({"rowpad_conv_fused": 20, "nms_walk": 1,
                 "rowpad_nbr": NBR_LAUNCHES})
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
    want.update({"nms_walk": TRAIN_BATCH,
                 "rowpad_conv": 39, "rowpad_conv_dw": 20,
                 "boxes_iou_bev_pairwise": 2,
                 "boxes_overlap_bev": TRAIN_BATCH,
                 "rowpad_nbr": NBR_LAUNCHES * TRAIN_BATCH})
    return rec, timed_steps("two-stage train", model, trainer, batch,
                            device, want)[0]


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
        tables; K10 and K7 on the train-mode proposals), float32
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
    features), and one conv of each level.  K9 and K4 sum the same bf16
    products in f32 on the tensor cores in the same order, so K9 must equal
    K4 bit for bit, and both lie within K4's 2e-2 * max|ref| of the plain
    version on bf16 weights; each shape prints K9's time over K4's.
    Returns K9's record."""
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
              f"max abs diff from K4 {d4:.3g} (must be 0), {ms:.4f} ms vs K4 "
              f"{k4_ms:.4f} "
              f"ms (K9/K4 {ms / k4_ms:.3f}) vs plain {pms:.3f} ms, bound "
              f"{rc['bound_ms']:.4f} ms ({rc['bound_by']})")
        if not (err <= tol and d4 == 0.0):
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
        launches, _ = timed_steps("sliding train", model, trainer, batch,
                                  device, want)
    finally:
        rowpad_conv.USE_SLIDING = was
    return rec, launches


# phase 12: a Waymo-layout tree of TREE_FRAMES frames for train_det, on the
# flagship config (TREE_BASE, relative to the repo root)
TREE_BASE = "configs/det_model_cfgs/centerpoint_5sweeps.yaml"
TREE_FRAMES = 8
TREE_POINTS = 160_000        # entry()'s count, a Waymo frame's scale
TREE_OBJECTS = 48
EGO_STEP_M = 1.0             # the ego's motion a frame, along x
EGO_YAW = 0.01               # and its turn a frame, rad
FRAME_DT = 0.1               # s between Waymo frames (10 Hz)
LOADER_BATCHES = 4           # one epoch of 8 frames at batch 2


def ego_pose(f):
    """The ego's (4, 4) lidar -> world pose at frame f: EGO_STEP_M along x
    and EGO_YAW of turn a frame."""
    yaw = EGO_YAW * f
    pose = np.eye(4)
    pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    pose[0, 3] = EGO_STEP_M * f
    return pose


def write_waymo_tree(root, seed=0):
    """Writes one sequence in the layout of detzero_tpu_torch/data/
    waymo_dataset.py under `root`: <seq>/NNNN.npy frames, the info pkl
    with 9-wide gt_boxes_lidar and a GT-database pickle of every object's
    crop in every frame; returns the path of a yaml on TREE_BASE that
    points DATA_PATH and the database there.  The frames are the port's
    SyntheticWaymoDataset scenes (their objects move at constant velocity
    within a sequence), seen from poses that move EGO_STEP_M and turn
    EGO_YAW a frame; velocities are the generator's displacement from one
    frame to the next over FRAME_DT, in the lidar frame."""
    import pickle
    from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
    from detzero_tpu_torch.data.waymo_dataset import SyntheticWaymoDataset
    from detzero_tpu_torch.ops import box_np

    root = Path(root)
    cfg = cfg_from_yaml_file(TREE_BASE, Config())
    cfg.update(SYNTHETIC_POINTS=TREE_POINTS, SYNTHETIC_OBJECTS=TREE_OBJECTS,
               SYNTHETIC_SEED=seed)
    gen = SyntheticWaymoDataset(cfg, cfg["CLASS_NAMES"], training=False)
    seq = "segment-synthetic_000"
    (root / "waymo_processed_data" / seq).mkdir(parents=True)
    infos, db = [], {n: [] for n in cfg["CLASS_NAMES"]}
    for f in range(TREE_FRAMES):
        pts, boxes_w, names = gen.generate_scene(f)
        next_xy = gen.generate_scene(f + 1)[1][:, :2]
        yaw = EGO_YAW * f
        pose = ego_pose(f)
        inv = np.linalg.inv(pose)
        lidar = np.full((len(pts), 6), -1.0, np.float32)
        lidar[:, :3] = pts[:, :3] @ inv[:3, :3].T + inv[:3, 3]
        lidar[:, 3:5] = pts[:, 3:5]          # intensity, elongation
        boxes = np.zeros((len(boxes_w), 9), np.float32)
        boxes[:, :3] = boxes_w[:, :3] @ inv[:3, :3].T + inv[:3, 3]
        boxes[:, 3:6] = boxes_w[:, 3:6]
        boxes[:, 6] = boxes_w[:, 6] - yaw
        boxes[:, 7:9] = (next_xy - boxes_w[:, :2]) / FRAME_DT @ inv[:2, :2].T
        np.save(root / "waymo_processed_data" / seq / f"{f:04d}.npy", lidar)
        counts = []
        for b, name in zip(boxes, names):
            inside = box_np.points_in_rotated_box(lidar, b[:7])
            crop = np.zeros((int(inside.sum()), 6), np.float32)
            crop[:, :5] = lidar[inside, :5]      # time offset 0
            counts.append(len(crop))
            db[name].append({"name": name, "box": b[:7].copy(),
                             "points": crop, "num_points_in_gt": len(crop),
                             "sample_idx": f})
        infos.append({"point_cloud": {"lidar_sequence": seq,
                                      "sample_idx": f},
                      "pose": pose.astype(np.float32),
                      "frame_id": f"{seq}_{f:03d}",
                      "annos": {"name": names, "gt_boxes_lidar": boxes,
                                "num_points_in_gt": np.asarray(counts)}})
    # the same frames for train_det (split train) and test_det (val)
    for split in ("train", "val"):
        with open(root / f"waymo_infos_{split}.pkl", "wb") as fh:
            pickle.dump(infos, fh)
    with open(root / "waymo_dbinfos_train.pkl", "wb") as fh:
        pickle.dump(db, fh)
    augs = [dict(a) for a in cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"]]
    for a in augs:
        if a["NAME"] == "gt_sampling":
            a["DB_INFO_PATH"] = str(root / "waymo_dbinfos_train.pkl")
            a["SEED"] = seed         # the sampler's draws, as the rest
    path = root / "centerpoint_5sweeps_tree.yaml"
    # the list in flow style: JSON is a flow collection of the subset
    path.write_text(f"_BASE_CONFIG_: {TREE_BASE}\n"
                    f"DATA_PATH: {json.dumps(str(root))}\n"
                    f"DATA_AUGMENTOR:\n"
                    f"  AUG_CONFIG_LIST: {json.dumps(augs)}\n")
    return path


@contextlib.contextmanager
def profiled_calls(cls, name, out):
    """While open, every call of cls.name runs under torch.profiler and
    sets out["wall_ms"] (host clock to a synchronised end) and
    out["busy_ms"] (the union of the card's kernel intervals,
    chip_profile.busy_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_profile import busy_ms

    orig = getattr(cls, name)

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = orig(*args, **kwargs)
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["busy_ms"] = busy_ms(prof)
        return res

    setattr(cls, name, call)
    try:
        yield out
    finally:
        setattr(cls, name, orig)


def run_train_det(device, fixed_step_ms, tmp):
    """Phase 12 in the directory `tmp` (the tree goes to tmp/waymo, the
    experiment to tmp/output).  Returns ({kernel name: record of its check
    at the new shapes}, {kernel name: launches a step}, the tree's yaml)."""
    import torch
    from detzero_tpu_torch.core.checkpoint import CheckpointManager
    from detzero_tpu_torch.data.waymo_dataset import build_dataloader
    from detzero_tpu_torch.parallel.trainer import Trainer
    from detzero_tpu_torch.tools import common, train_det

    smi = nvidia_smi_line()
    cwd = os.getcwd()
    os.chdir(REPO)        # the yamls' _BASE_CONFIG_ paths are relative
    try:
        t0 = time.perf_counter()
        yaml_path = write_waymo_tree(Path(tmp) / "waymo")
        print(f"[train_det] wrote {TREE_FRAMES} frames of {TREE_POINTS} "
              f"points, {TREE_OBJECTS} objects each, in "
              f"{time.perf_counter() - t0:.1f} s")
        cfg = common.load_config(common.base_parser("").parse_args(
            ["--cfg_file", str(yaml_path)]))

        # the loader alone, and the new shapes on its first batch
        dataset = common.build_detection_dataset(
            cfg, training=True, rng=np.random.RandomState(0))
        loader = build_dataloader(dataset, TRAIN_BATCH, shuffle=True,
                                  num_workers=2)
        times, first = [], None
        t0 = time.perf_counter()
        for b in loader(0):
            times.append((time.perf_counter() - t0) * 1e3)
            first = first or b
            t0 = time.perf_counter()
        if len(times) != LOADER_BATCHES:
            raise AssertionError(f"loader gave {len(times)} batches")
        loader_ms = sum(times) / len(times)
        print(f"[train_det] loader: {', '.join(f'{t:.1f}' for t in times)}"
              f" ms a batch; points valid "
              f"{first['points_valid'].sum(1).tolist()} of "
              f"{first['points'].shape[1]}, GT "
              f"{first['gt_valid'].sum(1).tolist()} (width "
              f"{first['gt_boxes'].shape[2]})")
        rec, kept = check_train_det_shapes(cfg, first, device)

        # one loader thread (beside the trainer's prefetch thread): the
        # samples' augmentation draws from one RandomState, so two threads
        # would interleave its draws differently in every run, and phase
        # 13's load depends on the checkpoint these steps write
        out = Path(tmp) / "output"
        args = ["--cfg_file", str(yaml_path), "--device", str(device),
                "--workers", "0", "--output_dir", str(out),
                "--log_every", "1"]
        exp = out / yaml_path.stem / "default" / "ckpt"
        want = step_launches()

        def run(max_steps, n_steps):
            reset_counts()
            trainer = train_det.main(args + ["--max_steps",
                                             str(max_steps)])
            torch.cuda.synchronize()
            got = read_counts()
            if got != {k: n_steps * v for k, v in want.items()}:
                raise AssertionError(f"train_det to step {max_steps}: "
                                     f"launches {got}, expected "
                                     f"{n_steps} x {want}")
            if trainer.step_count != max_steps:
                raise AssertionError(f"train_det ended at step "
                                     f"{trainer.step_count}, not "
                                     f"{max_steps}")
            return trainer

        run(4, 4)          # the trainer is freed at once
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        trainer = run(6, 2)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        lines = [json.loads(x) for x in
                 (exp / "metrics.jsonl").read_text().splitlines()]
        if [x["step"] for x in lines] != list(range(1, 7)):
            raise AssertionError(f"metrics.jsonl steps "
                                 f"{[x['step'] for x in lines]}: the "
                                 f"second run did not resume at 4")
        if not all(np.isfinite(v) for x in lines for v in x.values()):
            raise AssertionError("metrics.jsonl holds a value that is "
                                 "not finite")
        saved, step = CheckpointManager(exp).restore_any()
        live = trainer.model.state_dict()
        if step != 6 or saved["model"].keys() != live.keys() or not all(
                torch.equal(saved["model"][k], v.cpu())
                for k, v in live.items()):
            raise AssertionError(f"checkpoint of step {step} differs "
                                 f"from the live model")
        t0 = time.perf_counter()
        trainer.save()
        save_ms = (time.perf_counter() - t0) * 1e3
        ckpt_bytes = trainer.ckpt.path(6).stat().st_size
        fit_ms = [x["ms_per_it"] for x in lines[4:]]
        for x in lines:
            print(f"[train_det] metrics step {x['step']}: loss "
                  f"{x['loss']:.4f}, gnorm {x['gnorm']:.4f}, "
                  f"{x['ms_per_it']:.1f} ms/it")
        del trainer
        torch.cuda.empty_cache()

        with profiled_calls(Trainer, "fit", {}) as prof:
            run(8, 2)
        idle = 1.0 - prof["busy_ms"] / prof["wall_ms"]
        print(f"[train_det] fit to step 8 under torch.profiler: wall "
              f"{prof['wall_ms']:.1f} ms, card busy "
              f"{prof['busy_ms']:.1f} ms, idle share {idle:.3f}")
    finally:
        os.chdir(cwd)

    print(f"[train_det] {smi}: loader {loader_ms:.1f} ms a batch (mean of "
          f"{LOADER_BATCHES}, 2 threads); fit {sum(fit_ms) / 2:.1f} ms/step "
          f"over the resumed steps 5-6 ({fit_ms[0]:.1f}, {fit_ms[1]:.1f}); "
          f"phase 6's step on its fixed batch {fixed_step_ms:.1f} ms")
    print(f"[train_det] {smi}: idle share in fit {idle:.3f} (steps 7-8, "
          f"its first batch's wait and final save included); peak memory "
          f"{peak:.2f} GiB (steps 5-6); checkpoint {ckpt_bytes} bytes, "
          f"saved in {save_ms:.1f} ms")
    print(f"[train_det] {smi}: pillars kept a level (capacity): " + "; ".join(
        f"sample {i}: " + ", ".join(f"L{lv} {k} ({c})" for lv, (k, c) in
                                    enumerate(levels))
        for i, levels in enumerate(kept)))
    print(f"[train_det] launches a step: {want}")
    return rec, want, yaml_path


# phase 13: test_det and the tracker on phase 12's tree and checkpoint.
# The checkpoint has trained 8 steps from random weights, which keep no box
# above the flagship's score threshold of 0.1 (phase 4): test_det keeps
# every box of positive score instead, at most 64 a sample, so that WBF,
# the evaluator and the tracker get real detections in bounded time (the
# tracker is numpy; 768 boxes a frame take it minutes a frame).
DET_SET = ["MODEL.POST_PROCESSING.SCORE_THRESH", "0.0",
           "MODEL.POST_PROCESSING.NMS_POST_MAXSIZE", "64"]
TTA_VARIANTS = 15            # the original and waymo_5sweeps.yaml's 14
TTA_FRAMES = 2               # --max_batches under TTA (a frame a batch)
TRACK_FRAMES = 200           # a Waymo segment: 20 s at 10 Hz
TRACK_NOISE_M = 0.1          # the box-only sequence's centre noise
TRACK_NOISE_RAD = 0.02       # and heading noise
TRACK_DROP = 0.05            # share of detections dropped
TRACK_CFG = "configs/tk_model_cfgs/waymo_detzero_track.yaml"
# the tracker on test_det's result: the 8-step checkpoint's boxes need not
# clear the tracker's SCORE_THRESH (0.1) nor recur in 5 of the 8 frames
# (LEAST_AGE), so every box may start a track and every track is kept
TRACK_SET = ["MODEL.TRACKING.SCORE_THRESH", "0.0",
             "MODEL.POST_PROCESSING.LEAST_AGE", "1"]


def global_boxes(boxes, pose):
    """(N, 7+) lidar-frame boxes -> (N, 7) in the frame of `pose`."""
    out = np.array(boxes, float)[:, :7]
    out[:, :3] = out[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    out[:, 6] += np.arctan2(pose[1, 0], pose[0, 0])
    return out


def box_only_sequence(seed=0):
    """A box-only detection sequence of TRACK_FRAMES frames (no points):
    the 48 objects of the tree generator's frame 0 carried at their
    velocities (the generator's displacement a frame), seeded noise of
    TRACK_NOISE_M on the centre and TRACK_NOISE_RAD on the heading,
    TRACK_DROP of the detections dropped, scores U(0.3, 1), an identity
    pose.  Returns (det_annos, {seq: GT frames in eval_track's layout})."""
    from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
    from detzero_tpu_torch.data.waymo_dataset import SyntheticWaymoDataset

    cfg = cfg_from_yaml_file(TREE_BASE, Config())
    cfg.update(SYNTHETIC_POINTS=TREE_POINTS, SYNTHETIC_OBJECTS=TREE_OBJECTS,
               SYNTHETIC_SEED=seed)
    gen = SyntheticWaymoDataset(cfg, cfg["CLASS_NAMES"], training=False)
    _, b0, names = gen.generate_scene(0)
    step = gen.generate_scene(1)[1][:, :2] - b0[:, :2]
    rng = np.random.RandomState(seed)
    seq = "segment-boxes_000"
    dets, gt = [], []
    for f in range(TRACK_FRAMES):
        boxes = b0.astype(float)
        boxes[:, :2] += step * f
        gt.append({"boxes": boxes.copy(), "obj_ids": np.arange(len(boxes))})
        boxes[:, :3] += rng.randn(len(boxes), 3) * TRACK_NOISE_M
        boxes[:, 6] += rng.randn(len(boxes)) * TRACK_NOISE_RAD
        keep = rng.rand(len(boxes)) >= TRACK_DROP
        dets.append({"name": names[keep],
                     "score": rng.uniform(0.3, 1.0, int(keep.sum())),
                     "boxes_lidar": boxes[keep], "frame_id": f,
                     "sequence_name": seq, "pose": np.eye(4)})
    return dets, {seq: gt}


def track_and_eval(tag, data_path, gt, out_dir, min_tracks, overrides=()):
    """run_track (with `overrides` to the tracker's config) then
    eval_track on one result pickle; prints tracks, frames/s and the
    metrics, and fails on fewer than `min_tracks` tracks or a metric that
    is not finite.  The tracker is host code: it must launch no kernel."""
    import pickle

    from detzero_tpu_torch.tools import eval_track, run_track

    n_frames = sum(len(v) for v in gt.values())
    gt_path = Path(out_dir) / f"gt_{tag}.pkl"
    gt_path.parent.mkdir(parents=True, exist_ok=True)
    gt_path.write_bytes(pickle.dumps(gt))
    reset_counts()
    t0 = time.perf_counter()
    tracked = run_track.main(["--cfg_file", TRACK_CFG, "--data_path",
                              str(data_path), "--output_dir",
                              str(Path(out_dir) / tag), "--workers", "2",
                              *(["--set", *overrides] if overrides else [])])
    dt = time.perf_counter() - t0
    metrics = eval_track.main(["--track_path", str(tracked["track_path"]),
                               "--gt_path", str(gt_path)])
    n_tracks = sum(len(v["tracks"]) for v in tracked["tracks"].values())
    print(f"[tracking] {tag}: {n_frames} frames, {n_tracks} tracks in "
          f"{dt * 1e3:.1f} ms, {n_frames / dt:.2f} frames/s; " + ", ".join(
              f"{k} {v:.4f}" for k, v in metrics.items()))
    if any(read_counts().values()):
        raise AssertionError(f"tracking launched kernels: {read_counts()}")
    if n_tracks < min_tracks:
        raise AssertionError(f"{tag}: {n_tracks} tracks")
    if set(metrics) != {"recall", "precision", "MOTA", "MOTP"} or not all(
            np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{tag}: eval_track metrics {metrics}")
    return n_frames / dt, metrics


def loader_ms_a_frame(cfg, native):
    """ms a frame of one pass of test_det's loader over the test split
    (batch 2, 2 threads), on the native or the numpy sweep reader."""
    from detzero_tpu_torch.core.config import Config
    from detzero_tpu_torch.data import waymo_dataset
    from detzero_tpu_torch.tools import common

    cfg = Config(cfg)
    cfg["USE_NATIVE_LOADER"] = native
    ds = common.build_detection_dataset(cfg, training=False)
    loader = waymo_dataset.build_dataloader(ds, TRAIN_BATCH, shuffle=False,
                                            num_workers=2, drop_last=False)
    before = waymo_dataset.NATIVE_SAMPLES
    t0 = time.perf_counter()
    n = sum(len(b["points"]) for b in loader(0))
    ms = (time.perf_counter() - t0) * 1e3 / n
    if waymo_dataset.NATIVE_SAMPLES - before != (n if native else 0):
        raise AssertionError("the loader did not take the path asked for")
    return ms


def run_test_det(device, tmp, yaml_path):
    """Phase 13: `test_det.main` on phase 12's tree (split val, the same 8
    frames) and newest checkpoint, then with TTA, WBF "members" on the
    card against the CPU, the evaluator on the tree's own GT, and the
    tracker on test_det's result and on a box-only sequence.  Returns
    {path: {kernel name: launches}}."""
    import pickle

    import torch
    from detzero_tpu_torch.data import tta, waymo_dataset
    from detzero_tpu_torch.tools import common, test_det

    smi = nvidia_smi_line()
    out = Path(tmp) / "output"
    args = ["--cfg_file", str(yaml_path), "--device", str(device),
            "--workers", "2", "--output_dir", str(out)]
    per_sample = {"stream_rowpad_feats": 1, "rowpad_conv_fused": 20,
                  "rowpad_nbr": NBR_LAUNCHES, "nms_walk": 1}
    by_path = {}

    def counted(path, extra, frames, samples):
        reset_counts()
        before = waymo_dataset.NATIVE_SAMPLES
        res = test_det.main(args + extra)
        torch.cuda.synchronize()
        got = read_counts()
        t = res["timings"]
        want = dict.fromkeys(COUNTERS, 0)
        want.update({k: v * samples for k, v in per_sample.items()})
        if got != want or t["samples"] != samples:
            raise AssertionError(f"{path}: launches {got} over "
                                 f"{t['samples']} samples, expected {want}")
        native = waymo_dataset.NATIVE_SAMPLES - before
        if (t["frames"], native) != (frames, frames):
            raise AssertionError(f"{path}: {t['frames']} frames, {native} "
                                 f"read natively, expected {frames}")
        by_path[path] = got
        kept = sum(len(d["name"]) for d in res["det_annos"])
        wall = t["load_s"] + t["predict_s"] + t["wbf_s"]
        print(f"[test_det] {path}: {frames} frames ({samples} samples) "
              f"from checkpoint step {res['step']}, {kept} boxes; "
              f"{frames / wall:.3f} frames/s from data; loader wait "
              f"{t['load_s'] * 1e3 / frames:.1f}, predict "
              f"{t['predict_s'] * 1e3 / frames:.1f}, WBF "
              f"{t['wbf_s'] * 1e3 / frames:.1f} ms a frame; launches {got}")
        return res

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        res = counted("test_det", ["--save_to_file", "--set", *DET_SET],
                      TREE_FRAMES, TREE_FRAMES)
        print("[test_det] evaluation:\n" + res["table"])
        cfg = common.load_config(common.base_parser("").parse_args(
            ["--cfg_file", str(yaml_path)]))
        native_ms = loader_ms_a_frame(cfg, True)
        numpy_ms = loader_ms_a_frame(cfg, False)
        print(f"[test_det] {smi}: loader alone, native {native_ms:.1f} "
              f"against numpy {numpy_ms:.1f} ms a frame (batch "
              f"{TRAIN_BATCH}, 2 threads, {TREE_FRAMES} frames)")

        # TTA: each frame's 15 variants through predict, fused by WBF;
        # the variants' boxes of the first frame kept for "members"
        variants = []
        fuse = test_det.fuse_tta

        def keep_variants(dicts, batch, class_names):
            if not variants:
                variants.extend(
                    (tta.invert_boxes(d["boxes_lidar"], n), d["name"],
                     d["score"]) for d, n in zip(dicts, batch["tta_name"]))
            return fuse(dicts, batch, class_names)

        test_det.fuse_tta = keep_variants
        try:
            tta_res = counted("test_det_tta",
                              ["--max_batches", str(TTA_FRAMES), "--set",
                               *DET_SET, "TTA", "True"], TTA_FRAMES,
                              TTA_FRAMES * TTA_VARIANTS)
        finally:
            test_det.fuse_tta = fuse
        if len(variants) != TTA_VARIANTS:
            raise AssertionError(f"{len(variants)} TTA variants")
        wbf_ms = tta_res["timings"]["wbf_s"] * 1e3 / TTA_FRAMES
        print(f"[test_det] {smi}: TTA WBF {wbf_ms:.1f} ms a frame over "
              f"{TTA_VARIANTS} variants")

        by_path["wbf_members"] = check_members(variants, device)
        check_gt_as_detections(cfg)

        # the tracker on test_det's result, and on a box-only segment
        ds = common.build_detection_dataset(cfg, training=False)
        seq = ds.infos[0]["point_cloud"]["lidar_sequence"]
        gt = {seq: [{"boxes": global_boxes(i["annos"]["gt_boxes_lidar"],
                                           i["pose"]),
                     "obj_ids": np.arange(len(i["annos"]["name"]))}
                    for i in ds.infos]}
        top = max((float(d["score"].max()) for d in res["det_annos"]
                   if len(d["score"])), default=0.0)
        print(f"[tracking] test_det's result: top score {top:.4f}; "
              f"tracker overrides {TRACK_SET}")
        track_and_eval("test_det", res["result_path"], gt, out / "track",
                       min_tracks=1, overrides=TRACK_SET)
        dets, gt = box_only_sequence()
        data = out / "track" / "boxes_result.pkl"
        data.write_bytes(pickle.dumps(dets))
        fps, _ = track_and_eval("box_only", data, gt, out / "track",
                                min_tracks=TREE_OBJECTS // 2)
        print(f"[tracking] {smi}: box-only {TRACK_FRAMES} frames x "
              f"{TREE_OBJECTS} objects: {fps:.2f} frames/s")
    finally:
        os.chdir(cwd)
    return by_path


def check_members(variants, device):
    """WBF "members" on one TTA frame's boxes, class by class, on the card
    against the same call on the CPU: equal clusters and scores, boxes
    within 1e-4, one K7 launch a class of more than 32 boxes.  Returns
    {kernel name: launches}."""
    import torch
    from detzero_tpu_torch.ops import wbf

    boxes = np.concatenate([v[0] for v in variants])
    names = np.concatenate([v[1] for v in variants])
    scores = np.concatenate([v[2] for v in variants])
    total = dict.fromkeys(COUNTERS, 0)
    big = 0
    for cls in ("Vehicle", "Pedestrian", "Cyclist"):
        m = names == cls
        kw = dict(iou_thresh=wbf.DEFAULT_IOU_THRESH[cls], iou_mode="members",
                  n_models=TTA_VARIANTS)
        reset_counts()
        t0 = time.perf_counter()
        card = wbf.weighted_boxes_fusion_3d(boxes[m], scores[m],
                                            device=device, **kw)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        got = read_counts()
        t0 = time.perf_counter()
        cpu = wbf.weighted_boxes_fusion_3d(boxes[m], scores[m],
                                           device="cpu", **kw)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        n = int((scores[m] > 0).sum())
        big += n > 32
        want = dict.fromkeys(COUNTERS, 0)
        want["boxes_overlap_bev"] = int(n > 32)
        if got != want:
            raise AssertionError(f"members {cls} ({n} boxes): launches "
                                 f"{got}, expected {want}")
        err = float(np.abs(card[0] - cpu[0]).max()) if n else 0.0
        if card[2] != cpu[2] or not np.array_equal(card[1], cpu[1]) \
                or err > 1e-4:
            raise AssertionError(f"members {cls}: the card's clusters or "
                                 f"boxes differ from the CPU's (max abs "
                                 f"box err {err})")
        print(f"[wbf] members {cls}: {n} boxes -> {len(card[2])} clusters, "
              f"equal on the card and the CPU (max abs box err {err:.3g}); "
              f"{card_ms:.1f} ms with the card's IoU, {cpu_ms:.1f} ms with "
              f"the CPU's")
        for k, v in got.items():
            total[k] += v
    if not big:
        raise AssertionError("no class of the TTA frame has more than 32 "
                             "boxes: members took no K7 launch")
    return total


def check_gt_as_detections(cfg):
    """The evaluator on the tree's own GT offered as detections (score 1):
    AP 1.0 at L1 and L2 for every class present."""
    from detzero_tpu_torch.tools import common

    ds = common.build_detection_dataset(cfg, training=False)
    annos = [{"name": i["annos"]["name"],
              "score": np.ones(len(i["annos"]["name"])),
              "boxes_lidar": i["annos"]["gt_boxes_lidar"],
              "frame_id": i["point_cloud"]["sample_idx"]} for i in ds.infos]
    _, res = ds.evaluation(annos, cfg["CLASS_NAMES"])
    present = sorted(set(np.concatenate([a["name"] for a in annos])))
    for cls in present:
        if abs(res[cls]["AP_L1"] - 1) > 1e-9 or \
                abs(res[cls]["AP_L2"] - 1) > 1e-9:
            raise AssertionError(f"GT as detections: {cls} {res[cls]}")
    print("[test_det] GT as detections: AP_L1 = AP_L2 = 1.0 for " +
          ", ".join(present))


def check_train_det_shapes(cfg, batch, device):
    """Phase 12's kernel checks on the loader's first batch, on the
    config's model: K1 at F = len(used_feature_list) on sample 0, and the
    stem conv F -> 16 of K4 and K5 on the stacked batch.  Returns
    ({name: record}, per sample [(pillars kept, capacity) a level])."""
    import torch
    from detzero_tpu_torch.tools import common

    model = common.build_detector(cfg, device)
    b = {k: torch.from_numpy(batch[k]).to(device)
         for k in ("points", "points_valid", "gt_boxes", "gt_classes",
                   "gt_valid")}
    kept = []
    for i in range(b["points"].shape[0]):
        table = model.build_table(b["points"][i], b["points_valid"][i])
        plan = model.build_plan(table)
        kept.append([(int(plan[lv]["mask"].sum()), cap) for lv, cap in
                     enumerate(model.pillar_capacities)])
        if i == 0:
            rec, _ = check_vfe(model, table, "train_det")
    rec = {"stream_rowpad_feats": rec,
           **check_train_kernels(model, b, device, stem_only=True,
                                 tag="train_det")}
    del model
    torch.cuda.empty_cache()
    return rec, kept


# phase 14: the refining stage from tracks (the README's "Full offboard
# pipeline", steps 3 and 4) at the Vehicle configs' full width
REFINE_SEQS = 4
REFINE_FRAMES = 20
REFINE_CFGS = {"grm": "configs/ref_model_cfgs/vehicle_grm.yaml",
               "prm": "configs/ref_model_cfgs/vehicle_prm.yaml",
               "crm": "configs/ref_model_cfgs/vehicle_crm.yaml"}
REFINE_STEPS = 6
REFINE_TTA = {"grm": 10, "prm": 18}          # the default variant lists
REFINE_CLASSES = ("Vehicle", "Pedestrian", "Cyclist")   # the tracker's
REFINE_PHASE_S = 120.0


def write_refine_tree(root):
    """REFINE_SEQS sequences of REFINE_FRAMES frames under `root`:
    <seq>/NNNN.npy LIDAR frames (x, y, z, intensity, elongation, NLZ -1)
    of the port's SyntheticWaymoDataset scenes (seeds 0, 1, ...; one
    sequence's TREE_OBJECTS objects in all its frames), posed as phase 12
    poses them (`ego_pose`).  Returns {seq: [{pose, names, boxes_global,
    boxes_lidar} a frame]}."""
    from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
    from detzero_tpu_torch.data.waymo_dataset import SyntheticWaymoDataset

    seqs = {}
    for seed in range(REFINE_SEQS):
        cfg = cfg_from_yaml_file(TREE_BASE, Config())
        cfg.update(SYNTHETIC_POINTS=TREE_POINTS,
                   SYNTHETIC_OBJECTS=TREE_OBJECTS, SYNTHETIC_SEED=seed)
        gen = SyntheticWaymoDataset(cfg, cfg["CLASS_NAMES"], training=False)
        gen.FRAMES_PER_SEQ = REFINE_FRAMES
        seq = f"segment-refine_{seed:03d}"
        (Path(root) / seq).mkdir(parents=True)
        frames = []
        for f in range(REFINE_FRAMES):
            pts, boxes_w, names = gen.generate_scene(f)
            pose = ego_pose(f)
            inv = np.linalg.inv(pose)
            lidar = np.full((len(pts), 6), -1.0, np.float32)
            lidar[:, :3] = pts[:, :3] @ inv[:3, :3].T + inv[:3, 3]
            lidar[:, 3:5] = pts[:, 3:5]
            np.save(Path(root) / seq / f"{f:04d}.npy", lidar)
            boxes = np.array(boxes_w[:, :7], np.float32)
            boxes[:, :3] = boxes_w[:, :3] @ inv[:3, :3].T + inv[:3, 3]
            boxes[:, 6] -= EGO_YAW * f
            frames.append({"pose": pose, "names": np.asarray(names),
                           "boxes_global": np.asarray(boxes_w[:, :7]),
                           "boxes_lidar": boxes})
        seqs[seq] = frames
    return seqs


def refine_cfg(kind, data_path):
    from detzero_tpu_torch.tools import common

    return common.load_config(common.base_parser("").parse_args(
        ["--cfg_file", REFINE_CFGS[kind], "--set", "DATA_PATH",
         str(data_path)]))


def check_refine_card_cpu(device, data_path):
    """GRM, PRM and CRM at the Vehicle yamls' width on seeded weights:
    forward and decode of one batch (the yaml's size) of the Vehicle eval
    records on the card and on the CPU, float32 both.  Every output finite
    (the padded PRM queries' rows included); each raw output and decoded
    value within 1e-4 of the CPU's, relative to the CPU output's largest
    magnitude (PRM's heading where the top two bin logits differ by more
    than 1e-4: elsewhere the argmax may take either bin)."""
    import torch
    from detzero_tpu_torch.models.refining.batched import (
        _SAMPLE_KEYS, forward_decode,
    )
    from detzero_tpu_torch.tools.train_refine import (
        MODEL_KIND, build_refine_dataset, build_refine_model, size_anchors,
    )

    smi = nvidia_smi_line()
    for kind in REFINE_CFGS:
        cfg = refine_cfg(kind, data_path)
        ds = build_refine_dataset(cfg, training=False)
        n = int(cfg["OPTIMIZATION"]["BATCH_SIZE_PER_DEVICE"])
        samples = [ds[i % len(ds)] for i in range(n)]
        for s in samples:
            s["anchors"] = size_anchors(cfg)
        arrs = [torch.from_numpy(np.stack([s[k] for s in samples]))
                for k in _SAMPLE_KEYS[kind]]
        outs, ms = [], []
        for dev in (device, torch.device("cpu")):
            model = build_refine_model(cfg, dev, seed=0)
            assert MODEL_KIND[cfg["MODEL"]["NAME"]] == kind
            x = [a.to(dev) for a in arrs]
            with torch.no_grad():
                forward_decode(model, kind, *x)            # warm-up
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                dec = forward_decode(model, kind, *x)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                raw = model(*x[:len(x) - (kind == "grm")])
            dec = dec if isinstance(dec, tuple) else (dec,)
            outs.append({**{k: v.cpu() for k, v in raw.items()},
                         **{f"decoded{i}": v.cpu()
                            for i, v in enumerate(dec)}})
            del model
        card, cpu = outs
        worst = 0.0
        for k, a in cpu.items():
            b = card[k]
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"refining {kind}: {k} not finite")
            d = (a - b).abs()
            if kind == "prm" and k == "decoded1":
                top = cpu["heading_logits"][:, -1].topk(2, -1).values
                d = d[(top[..., 0] - top[..., 1]) > 1e-4]
            rel = float(d.max()) / max(float(a.abs().max()), 1e-30)
            worst = max(worst, rel)
            if rel > 1e-4:
                raise AssertionError(f"refining {kind}: card and CPU differ "
                                     f"on {k} by {rel:.3g} of its scale")
        pad = int((~arrs[3]).sum()) if kind == "prm" else 0
        print(f"[refining] {smi}: {cfg['MODEL']['NAME']} D_MODEL "
              f"{cfg['MODEL'].get('D_MODEL')} on {n} Vehicle tracks "
              f"({', '.join(f'{k} {tuple(a.shape)}' for k, a in zip(_SAMPLE_KEYS[kind], arrs))}"
              f"{f'; {pad} padded queries' if pad else ''}): card against "
              f"CPU within {worst:.3g} of scale, all finite; forward + "
              f"decode {ms[0]:.1f} ms on the card, {ms[1]:.1f} ms on the "
              f"CPU")


def run_refining(device, tmp):
    """Phase 14 in the directory `tmp`: the sequences, the tracker on their
    GT offered as detections, the daemon's crop (native) with GT matches
    and IoU labels, the per-class pickles and Vehicle's record cache; the
    three Vehicle models card against CPU; train_refine to REFINE_STEPS
    steps for each (then 2 more, resumed, under torch.profiler);
    test_refine for each, and under TTA for GRM and PRM.  No kernel may
    launch."""
    import pickle

    import torch
    from detzero_tpu_torch.parallel.trainer import Trainer
    from detzero_tpu_torch.pipeline import daemon
    from detzero_tpu_torch.tools import (
        build_record_cache, run_track, test_refine, train_refine,
    )

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    reset_counts()
    root, out = Path(tmp) / "lidar", Path(tmp) / "output"
    data = Path(tmp) / "refining"
    cwd = os.getcwd()
    os.chdir(REPO)        # the yamls' _BASE_CONFIG_ paths are relative
    try:
        t0 = time.perf_counter()
        seqs = write_refine_tree(root)
        n_frames = REFINE_SEQS * REFINE_FRAMES
        print(f"[refining] wrote {REFINE_SEQS} sequences x {REFINE_FRAMES} "
              f"frames of {TREE_POINTS} points, {TREE_OBJECTS} objects "
              f"each, in {time.perf_counter() - t0:.1f} s")

        # the tracker on the GT offered as detections (score 1)
        dets = [{"name": fr["names"], "score": np.ones(len(fr["names"])),
                 "boxes_lidar": fr["boxes_lidar"], "frame_id": f,
                 "sequence_name": seq, "pose": fr["pose"]}
                for seq, frames in seqs.items()
                for f, fr in enumerate(frames)]
        det_path = out / "gt_detections.pkl"
        det_path.parent.mkdir(parents=True)
        det_path.write_bytes(pickle.dumps(dets))
        t0 = time.perf_counter()
        tracked = run_track.main(["--cfg_file", TRACK_CFG, "--data_path",
                                  str(det_path), "--output_dir",
                                  str(out / "track"), "--workers",
                                  str(REFINE_SEQS)])["tracks"]
        dt = time.perf_counter() - t0
        n_tracks = sum(len(v["tracks"]) for v in tracked.values())
        print(f"[refining] tracker: {n_frames} frames, {n_tracks} tracks in "
              f"{dt:.1f} s, {n_frames / dt:.2f} frames/s")

        # the daemon: crop (native), GT matches, IoU labels, pickles, cache
        before = (daemon.NATIVE_FRAMES, daemon.NUMPY_FRAMES)
        crop_s, by_cls = 0.0, {}
        for seq, frames in seqs.items():
            pts = [np.load(root / seq / f"{f:04d}.npy")
                   for f in range(REFINE_FRAMES)]
            gts = [fr["boxes_global"] for fr in frames]
            t0 = time.perf_counter()
            recs = daemon.prepare_object_data(
                tracked[seq], pts, [fr["pose"] for fr in frames], nlz_col=5,
                gt_boxes=gts, gt_ids=[np.arange(len(g)) for g in gts])
            crop_s += time.perf_counter() - t0
            ious = daemon.generate_iou_gt(recs, {})
            for oid, rec in recs.items():
                rec["iou_gt"] = ious[oid]
                cls = REFINE_CLASSES[int(rec["label"])]
                by_cls.setdefault(cls, {}).setdefault(seq, {})[oid] = rec
        native = daemon.NATIVE_FRAMES - before[0]
        fallback = daemon.NUMPY_FRAMES - before[1]
        if (native, fallback) != (n_frames, 0):
            raise AssertionError(f"the daemon cropped {native} frames "
                                 f"natively and {fallback} in numpy, not "
                                 f"{n_frames} natively")
        for cls, per_seq in by_cls.items():
            for seq, recs in per_seq.items():
                path = data / cls / f"{seq}.pkl"
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_bytes(pickle.dumps(recs))
        counts = {cls: (sum(len(r) for r in per.values()),
                        sum(bool(np.any(x["matched"])) for r in per.values()
                            for x in r.values()))
                  for cls, per in by_cls.items()}
        print(f"[refining] daemon: {crop_s * 1e3 / n_frames:.1f} ms a frame "
              f"over {n_frames} frames, native cropper {native} frames, "
              f"numpy {fallback}; records (matched tracks) a class: "
              + ", ".join(f"{c} {n} ({m})" for c, (n, m) in counts.items()))
        t0 = time.perf_counter()
        build_record_cache.main(["--object_root", str(data), "--classes",
                                 "Vehicle"])
        cache_bytes = sum(p.stat().st_size
                          for p in (data / "Vehicle").glob("*.dzrc"))
        print(f"[refining] Vehicle record cache: {cache_bytes} bytes in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        grm_batch = int(refine_cfg("grm", data)["OPTIMIZATION"][
            "BATCH_SIZE_PER_DEVICE"])
        if counts.get("Vehicle", (0, 0))[1] < grm_batch:
            raise AssertionError(f"{counts.get('Vehicle')} Vehicle tracks: "
                                 f"fewer matched than GRM's batch of "
                                 f"{grm_batch}")

        check_refine_card_cpu(device, data)
        torch.cuda.empty_cache()

        for kind, yaml in REFINE_CFGS.items():
            args = ["--cfg_file", yaml, "--device", str(device),
                    "--output_dir", str(out), "--workers", "2", "--seed",
                    "0", "--log_every", "1"]
            over = ["--set", "DATA_PATH", str(data)]
            torch.cuda.reset_peak_memory_stats(device)
            trainer = train_refine.main(args + ["--max_steps",
                                                str(REFINE_STEPS)] + over)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            exp = out / Path(yaml).stem / "default" / "ckpt"
            lines = [json.loads(x) for x in
                     (exp / "metrics.jsonl").read_text().splitlines()]
            if [x["step"] for x in lines] != list(
                    range(1, REFINE_STEPS + 1)) or trainer.step_count != \
                    REFINE_STEPS:
                raise AssertionError(f"train_refine {kind}: steps "
                                     f"{[x['step'] for x in lines]}")
            if not all(np.isfinite(v) for x in lines for v in x.values()):
                raise AssertionError(f"train_refine {kind}: a metric that "
                                     f"is not finite")
            ckpt_bytes = trainer.ckpt.path(REFINE_STEPS).stat().st_size
            step_ms = [x["ms_per_it"] for x in lines[2:]]
            del trainer
            torch.cuda.empty_cache()
            with profiled_calls(Trainer, "fit", {}) as prof:
                train_refine.main(args + ["--max_steps",
                                          str(REFINE_STEPS + 2)] + over)
            idle = 1.0 - prof["busy_ms"] / prof["wall_ms"]
            print(f"[refining] {smi}: train_refine {kind} at batch "
                  f"{refine_cfg(kind, data)['OPTIMIZATION']['BATCH_SIZE_PER_DEVICE']}"
                  f": losses " + ", ".join(f"{x['loss']:.4f}" for x in lines)
                  + f"; {sum(step_ms) / len(step_ms):.1f} ms/step over "
                  f"steps 3-{REFINE_STEPS} ("
                  + ", ".join(f"{t:.1f}" for t in step_ms)
                  + f"); idle share {idle:.3f} in fit (steps "
                  f"{REFINE_STEPS + 1}-{REFINE_STEPS + 2}, resumed); peak "
                  f"memory {peak:.2f} GiB; checkpoint {ckpt_bytes} bytes")
            torch.cuda.empty_cache()

        for kind, yaml in REFINE_CFGS.items():
            for tta in ((False, True) if kind in REFINE_TTA else (False,)):
                res = test_refine.main(
                    ["--cfg_file", yaml, "--device", str(device),
                     "--output_dir", str(out), "--save_to_file",
                     *(["--tta"] if tta else []), "--set", "DATA_PATH",
                     str(data)])
                t = res["timings"]
                if res["step"] != REFINE_STEPS + 2 or not \
                        res["result_path"].exists():
                    raise AssertionError(f"test_refine {kind}: step "
                                         f"{res['step']}, no pickle")
                for per in res["results"].values():
                    for r in per.values():
                        if not all(np.isfinite(v).all() for v in r.values()):
                            raise AssertionError(f"test_refine {kind}: an "
                                                 f"output not finite")
                route = f"TTA ({REFINE_TTA[kind]} variants)" if tta \
                    else "batched"
                print(f"[refining] {smi}: test_refine {kind} {route}: "
                      f"{t['tracks']} tracks, {t['tracks'] / t['seconds']:.2f}"
                      f" tracks/s; recall@0.7 input {res['recall_in']:.4f} "
                      f"-> output {res['recall_out']:.4f} over "
                      f"{res['boxes']} boxes (untrained: printed, not "
                      f"checked); {res['result_path'].name}")
    finally:
        os.chdir(cwd)
    got = read_counts()
    if any(got.values()):
        raise AssertionError(f"the refining stage launched kernels: {got}")
    total = time.perf_counter() - t_phase
    print(f"[refining] phase 14 in {total:.1f} s, no kernel launched")
    if total > REFINE_PHASE_S:
        raise AssertionError(f"phase 14 took {total:.1f} s, over "
                             f"{REFINE_PHASE_S:.0f}")


# phase 15: the offboard pipeline from raw records (the README's "Full
# offboard pipeline", first and last steps): tfrecords -> infos and GT
# database -> test_det -> run_offboard -> detzero_eval -> submission .bin
OB_SEQS = 2
OB_FRAMES = 10
OB_RI_SHAPE = (64, 2650)     # the TOP lidar's range image: beams x columns
OB_LIDAR_Z = 2.0             # the TOP lidar's height in the vehicle frame, m
OB_MIN_POINTS = 100_000      # decoded points a frame, at least
OB_AP_L2 = 0.9               # Vehicle AP_L2 of the GT offered as detections
OB_PHASE_S = 150.0
OB_TYPES = {"Vehicle": 1, "Pedestrian": 2, "Sign": 3, "Cyclist": 4}


def beam_inclinations(incl, h):
    """h beam inclinations (ascending, rad) at the quantiles of the points'
    inclinations: a calibration's explicit, non-uniform beams, dense where
    the scene's points are (its far ground), as the TOP lidar's are near
    the horizon."""
    return np.quantile(incl, (np.arange(h) + 0.5) / h)


def project_two_returns(xyz, feats, inc, w):
    """Lidar-frame points (N, 3) (extrinsic: a translation of OB_LIDAR_Z up)
    -> two (H, W, 4) range images [range, intensity, elongation, NLZ]: the
    nearest point of a pixel in return 1, the next in return 2, NLZ -1 on
    every point (not in a no-label zone), the other pixels zero.  The
    inverse of `waymo_preprocess.range_image_to_points` up to the pixel's
    quantisation (the beam's inclination, the column's azimuth)."""
    h = len(inc)
    p = np.asarray(xyz, np.float64) - [0.0, 0.0, OB_LIDAR_Z]
    r = np.linalg.norm(p, axis=1)
    beam = np.searchsorted((inc[1:] + inc[:-1]) / 2,
                           np.arcsin(p[:, 2] / np.maximum(r, 1e-9)))
    col = np.round((np.pi - np.arctan2(p[:, 1], p[:, 0])) * w / (2 * np.pi)
                   - 0.5).astype(np.int64) % w
    pix = (h - 1 - beam) * w + col          # row 0 = the top beam
    order = np.lexsort((r, pix))
    ps = pix[order]
    first = np.r_[True, ps[1:] != ps[:-1]]
    at = np.arange(len(ps))
    rank = at - np.maximum.accumulate(np.where(first, at, 0))
    images = []
    for k in (0, 1):
        sel = order[rank == k]
        ri = np.zeros((h * w, 4), np.float32)
        ri[pix[sel], 0] = r[sel]
        ri[pix[sel], 1:3] = feats[sel]
        ri[pix[sel], 3] = -1.0
        images.append(ri.reshape(h, w, 4))
    return images


def write_offboard_records(raw_dir):
    """OB_SEQS sequences of OB_FRAMES frames as
    <seq>_with_camera_labels.tfrecord under `raw_dir`, through the port's
    codec and `write_tfrecord`: SyntheticWaymoDataset scenes of
    TREE_OBJECTS objects (seeds 20, 21, ...), posed as phase 12 poses them
    (`ego_pose`), projected into the TOP lidar's two returns; each frame
    with its pose, context name, timestamp and labels (box, type, id,
    difficulty, the scene's points in the box, counted by the native
    cropper).  Returns the sequences' names."""
    from detzero_tpu_torch import native
    from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
    from detzero_tpu_torch.data import waymo_preprocess as wp
    from detzero_tpu_torch.data.tfrecord_io import write_tfrecord
    from detzero_tpu_torch.data.waymo_dataset import SyntheticWaymoDataset
    from detzero_tpu_torch.protos import waymo_dataset_pb2 as wpb

    h, w = OB_RI_SHAPE
    extr = np.eye(4)
    extr[2, 3] = OB_LIDAR_Z
    seqs = []
    for s in range(OB_SEQS):
        cfg = cfg_from_yaml_file(TREE_BASE, Config())
        cfg.update(SYNTHETIC_POINTS=TREE_POINTS,
                   SYNTHETIC_OBJECTS=TREE_OBJECTS, SYNTHETIC_SEED=20 + s)
        gen = SyntheticWaymoDataset(cfg, cfg["CLASS_NAMES"], training=False)
        gen.FRAMES_PER_SEQ = OB_FRAMES
        seq = f"segment-offboard_{s:03d}"
        records = []
        for f in range(OB_FRAMES):
            pts, boxes_w, names = gen.generate_scene(f)
            pose = ego_pose(f)
            inv = np.linalg.inv(pose)
            xyz = pts[:, :3] @ inv[:3, :3].T + inv[:3, 3]
            boxes = np.array(boxes_w[:, :7], np.float64)
            boxes[:, :3] = boxes_w[:, :3] @ inv[:3, :3].T + inv[:3, 3]
            boxes[:, 6] -= EGO_YAW * f
            p = xyz - [0.0, 0.0, OB_LIDAR_Z]
            inc = beam_inclinations(
                np.arcsin(p[:, 2] / np.linalg.norm(p, axis=1)), h)
            ri1, ri2 = project_two_returns(xyz, pts[:, 3:5], inc, w)
            fr = wpb.Frame()
            fr.context.name = f"offboard_context_{s:03d}"
            fr.timestamp_micros = 1_600_000_000_000_000 + s * 10 ** 8 \
                + f * 100_000
            fr.pose.transform.extend(pose.ravel().tolist())
            cal = fr.context.laser_calibrations.add()
            cal.name = wpb.LaserName.TOP
            cal.beam_inclinations.extend(inc.tolist())
            cal.beam_inclination_min = float(inc[0])
            cal.beam_inclination_max = float(inc[-1])
            cal.extrinsic.transform.extend(extr.ravel().tolist())
            laser = fr.lasers.add()
            laser.name = wpb.LaserName.TOP
            laser.ri_return1.range_image_compressed = wp.encode_matrix(ri1)
            laser.ri_return2.range_image_compressed = wp.encode_matrix(ri2)
            n_ins = [len(c) for c in native.crop_points_multi(
                xyz.astype(np.float32), boxes, enlarge=1.0)]
            for i, (b, name, n_in) in enumerate(zip(boxes, names, n_ins)):
                lbl = fr.laser_labels.add()
                lbl.box.center_x, lbl.box.center_y, lbl.box.center_z = b[:3]
                lbl.box.length, lbl.box.width, lbl.box.height = b[3:6]
                lbl.box.heading = b[6]
                lbl.type = OB_TYPES[name]
                lbl.id = f"{seq}_{i:03d}"
                lbl.detection_difficulty_level = (
                    wpb.Label.LEVEL_2 if n_in <= 5 else wpb.Label.LEVEL_1)
                lbl.num_lidar_points_in_box = n_in
            records.append(fr.SerializeToString())
        write_tfrecord(Path(raw_dir) / f"{seq}_with_camera_labels.tfrecord",
                       records)
        seqs.append(seq)
    return seqs


@contextlib.contextmanager
def refiner_forwards(out):
    """While open, out["forwards"] counts the refiners' batched forwards
    and out["cpu_inputs"] the input tensors among them off the card; the
    first `BatchedRefiner.run` of each kind (GRM, PRM, CRM) runs under
    torch.profiler, out["device_kernels"] and out["busy_ms"] summing the
    card's kernels those launched and their union, out["profiled"] naming
    the kinds (the rest run unprofiled, so that the stage times stand)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_profile import busy_ms
    from detzero_tpu_torch.models.refining import batched

    run, fwd = batched.BatchedRefiner.run, batched.forward_decode
    out.update(forwards=0, cpu_inputs=0, device_kernels=0, busy_ms=0.0,
               profiled=[])

    def forward(model, kind, *arrs):
        out["forwards"] += 1
        out["cpu_inputs"] += sum(not a.is_cuda for a in arrs)
        return fwd(model, kind, *arrs)

    def call(self, samples):
        if self.kind in out["profiled"]:
            return run(self, samples)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run(self, samples)
            torch.cuda.synchronize()
        out["profiled"].append(self.kind)
        out["device_kernels"] += sum(e.device_type.name == "CUDA"
                                     for e in prof.events())
        out["busy_ms"] += busy_ms(prof)
        return res

    batched.BatchedRefiner.run, batched.forward_decode = call, forward
    try:
        yield out
    finally:
        batched.BatchedRefiner.run, batched.forward_decode = run, fwd


def check_final_frames(final, tag):
    """OB_SEQS sequences of OB_FRAMES final frames, every box and score
    finite; returns the box count."""
    n = 0
    if sorted(final) != [f"segment-offboard_{s:03d}"
                         for s in range(OB_SEQS)] or \
            any(len(v) != OB_FRAMES for v in final.values()):
        raise AssertionError(f"{tag}: final frames {[(k, len(v)) for k, v in final.items()]}")
    for frames in final.values():
        for fr in frames:
            if not (np.isfinite(fr["boxes"]).all()
                    and np.isfinite(fr["scores"]).all()):
                raise AssertionError(f"{tag}: a final box not finite")
            n += len(fr["boxes"])
    return n


def run_offboard_phase(device, tmp, det_ckpt, refine_ckpts):
    """Phase 15 in the directory `tmp`: records, preprocessing, test_det
    on the preprocessed tree with phase 12's checkpoint `det_ckpt`,
    run_offboard with phase 14's refiners ({kind: ckpt dir}), the chain on
    the GT offered as detections, and the submission.  Returns {kernel
    name: launches} of test_det."""
    import pickle

    import torch
    from detzero_tpu_torch.data import waymo_dataset
    from detzero_tpu_torch.data import waymo_preprocess as wp
    from detzero_tpu_torch.data.tfrecord_io import read_tfrecord
    from detzero_tpu_torch.pipeline import submit
    from detzero_tpu_torch.protos import waymo_metrics_pb2
    from detzero_tpu_torch.tools import (
        create_waymo_infos, detzero_eval, run_offboard, test_det,
    )

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    tmp = Path(tmp)
    raw, root, out = tmp / "raw", tmp / "waymo", tmp / "output"
    proc = root / "waymo_processed_data"
    for d in (raw, root / "ImageSets", out):
        d.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(REPO)        # the yamls' _BASE_CONFIG_ paths are relative
    try:
        # 1. the records
        t0 = time.perf_counter()
        seqs = write_offboard_records(raw)
        n_frames = OB_SEQS * OB_FRAMES
        rec_bytes = sum(p.stat().st_size for p in raw.iterdir())
        print(f"[offboard] wrote {OB_SEQS} tfrecords x {OB_FRAMES} frames "
              f"({TREE_POINTS} scene points, {TREE_OBJECTS} objects, a "
              f"{OB_RI_SHAPE[0]} x {OB_RI_SHAPE[1]} TOP range image of two "
              f"returns each; {rec_bytes} bytes) in "
              f"{time.perf_counter() - t0:.1f} s")

        # 2. preprocessing: infos, then the GT database, through the CLI;
        # every record read again with its CRCs verified and decoded
        (root / "ImageSets" / "val.txt").write_text("\n".join(seqs))
        t0 = time.perf_counter()
        infos = create_waymo_infos.main([
            "--stage", "infos", "--raw_dir", str(raw), "--out_dir",
            str(proc), "--split_file", str(root / "ImageSets" / "val.txt"),
            "--workers", "2"])
        infos_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        db = create_waymo_infos.main([
            "--stage", "gt_database", "--infos_path",
            str(root / "waymo_infos_val.pkl"), "--out_dir", str(proc),
            "--db_out", str(root / "waymo_dbinfos_val.pkl")])
        db_s = time.perf_counter() - t0
        if len(infos) != n_frames:
            raise AssertionError(f"{len(infos)} infos, not {n_frames}")
        counts, decode_s = [], 0.0
        for seq in seqs:
            recs = list(read_tfrecord(raw / f"{seq}_with_camera_labels"
                                      ".tfrecord", verify_crc=True))
            if len(recs) != OB_FRAMES:
                raise AssertionError(f"{seq}: {len(recs)} records")
            for f, rec in enumerate(recs):
                t0 = time.perf_counter()
                pts = wp.frame_points(wp.parse_frame(rec))
                decode_s += time.perf_counter() - t0
                saved = np.load(proc / seq / f"{f:04d}.npy")
                if not np.array_equal(saved, pts):
                    raise AssertionError(f"{seq} frame {f}: the .npy is not "
                                         f"the record's decode")
                counts.append(len(pts))
        if min(counts) < OB_MIN_POINTS:
            raise AssertionError(f"decoded points a frame {min(counts)}, "
                                 f"under {OB_MIN_POINTS}")
        gt_n = sum(len(i["annos"]["name"]) for i in infos)
        print(f"[offboard] {smi}: preprocessing: infos {infos_s:.2f} s "
              f"({infos_s * 1e3 / n_frames:.1f} ms a frame, 2 threads), "
              f"GT database {db_s:.2f} s ("
              + ", ".join(f"{k} {len(v)}" for k, v in db.items())
              + f"); decode alone {decode_s * 1e3 / n_frames:.1f} ms a "
              f"frame; CRCs verified on {n_frames} records; points a frame "
              f"{min(counts)}-{max(counts)} (mean {np.mean(counts):.0f}); "
              f"{gt_n} labels")

        # 3. test_det on the preprocessed tree, phase 12's checkpoint
        yaml_path = root / "centerpoint_5sweeps_offboard.yaml"
        yaml_path.write_text(f"_BASE_CONFIG_: {TREE_BASE}\n"
                             f"DATA_PATH: {json.dumps(str(root))}\n")
        per_sample = {"stream_rowpad_feats": 1, "rowpad_conv_fused": 20,
                      "rowpad_nbr": NBR_LAUNCHES, "nms_walk": 1}
        reset_counts()
        before = waymo_dataset.NATIVE_SAMPLES
        det = test_det.main([
            "--cfg_file", str(yaml_path), "--device", str(device),
            "--workers", "2", "--output_dir", str(out), "--ckpt",
            str(det_ckpt), "--save_to_file", "--set", *DET_SET])
        torch.cuda.synchronize()
        launches = read_counts()
        t = det["timings"]
        want = dict.fromkeys(COUNTERS, 0)
        want.update({k: v * n_frames for k, v in per_sample.items()})
        native = waymo_dataset.NATIVE_SAMPLES - before
        if launches != want or (t["samples"], t["frames"], native) != \
                (n_frames,) * 3:
            raise AssertionError(f"test_det: launches {launches} over "
                                 f"{t['samples']} samples ({native} read "
                                 f"natively), expected {want}")
        n_det = sum(len(d["name"]) for d in det["det_annos"])
        wall = t["load_s"] + t["predict_s"] + t["wbf_s"]
        print(f"[offboard] {smi}: test_det on the decoded tree: "
              f"{n_frames} frames from checkpoint step {det['step']}, "
              f"{n_det} boxes; {n_frames / wall:.3f} frames/s from data "
              f"(loader wait {t['load_s'] * 1e3 / n_frames:.1f}, predict "
              f"{t['predict_s'] * 1e3 / n_frames:.1f} ms a frame); launches "
              f"a sample " + ", ".join(f"{k} {v // n_frames}"
                                       for k, v in launches.items() if v))

        # 4. run_offboard on test_det's result and the preprocessed tree,
        # with phase 14's Vehicle refiners on the card
        stages = []
        for kind, ckpt in refine_ckpts.items():
            stages += [f"--{kind}_cfg", REFINE_CFGS[kind], f"--{kind}_ckpt",
                       str(ckpt)]
        reset_counts()
        with refiner_forwards({}) as fwd:
            t0 = time.perf_counter()
            off = run_offboard.main([
                "--det_path", str(det["result_path"]), "--points_root",
                str(proc), "--output_dir", str(out / "offboard"),
                "--device", str(device), *stages, "--track_cfg", TRACK_CFG,
                "--set", *TRACK_SET])
            off_s = time.perf_counter() - t0
        if any(read_counts().values()):
            raise AssertionError(f"run_offboard launched kernels of the "
                                 f"port: {read_counts()}")
        n_final = check_final_frames(off["final_frames"], "run_offboard")
        n_tracks = sum(len(pickle.loads(p.read_bytes())["tracks"])
                       for p in off["tracking_paths"].values())
        if fwd["forwards"] == 0 or fwd["cpu_inputs"] or \
                fwd["device_kernels"] == 0 or \
                sorted(fwd["profiled"]) != sorted(refine_ckpts):
            raise AssertionError(f"the refiners' forward did not run on the "
                                 f"card: {fwd}")
        print(f"[offboard] {smi}: run_offboard with GRM, PRM and CRM (the "
              f"Vehicle yamls, phase 14's checkpoints) on test_det's "
              f"result: {n_tracks} tracks, {n_final} final boxes over "
              f"{n_frames} frames, all finite, in {off_s:.2f} s; refiners: "
              f"{fwd['forwards']} batched forwards, all inputs on the card; "
              f"the first run of each kind under torch.profiler: "
              f"{fwd['device_kernels']} kernels on the card, busy "
              f"{fwd['busy_ms']:.1f} ms; stage seconds (StageTimer) "
              + ", ".join(f"{k} {v['total_s']:.3f}"
                          for k, v in off["timings"].items()))

        # 5. the chain on known boxes: the infos' GT as detections (score
        # 1), no refiners, the tracker's own config; GT posed into the
        # global frame, as the final frames are
        dets, gt_global, gt_lidar = [], {}, {}
        for info in infos:
            seq = info["point_cloud"]["lidar_sequence"]
            a = info["annos"]
            dets.append({"name": a["name"], "score": np.ones(len(a["name"])),
                         "boxes_lidar": a["gt_boxes_lidar"],
                         "frame_id": info["point_cloud"]["sample_idx"],
                         "sequence_name": seq, "pose": info["pose"]})
            for tgt, boxes in ((gt_global, global_boxes(a["gt_boxes_lidar"],
                                                        info["pose"])),
                               (gt_lidar, a["gt_boxes_lidar"])):
                tgt.setdefault(seq, []).append({
                    "gt_boxes": boxes, "name": a["name"],
                    "num_points": a["num_points_in_gt"]})
        for name, obj in (("gt_dets.pkl", dets), ("gt_global.pkl", gt_global),
                          ("gt_lidar.pkl", gt_lidar)):
            (out / name).write_bytes(pickle.dumps(obj))
        gt_off = run_offboard.main([
            "--det_path", str(out / "gt_dets.pkl"), "--points_root",
            str(proc), "--output_dir", str(out / "offboard_gt"),
            "--track_cfg", TRACK_CFG])
        n_gt_final = check_final_frames(gt_off["final_frames"], "GT chain")
        aps = {}
        for frame_name in ("global", "lidar"):
            res = detzero_eval.main([
                "--pred_path", str(gt_off["final_path"]), "--gt_path",
                str(out / f"gt_{frame_name}.pkl"), "--metric", "detection"])
            aps[frame_name] = res["Vehicle"]["AP_L2"]
        print(f"[offboard] GT as detections through the tracker, daemon, "
              f"combine and detzero_eval: {gt_n} GT boxes -> {n_gt_final} "
              f"final boxes; Vehicle AP_L2 {aps['global']:.4f} against the "
              f"GT posed into the global frame ({aps['lidar']:.4f} against "
              f"the infos' vehicle-frame GT as given)")
        if not aps["global"] >= OB_AP_L2:
            raise AssertionError(f"GT chain: Vehicle AP_L2 {aps['global']} "
                                 f"under {OB_AP_L2}")

        # 6. the submission of test_det's detections, read back
        by_key = {(i["point_cloud"]["lidar_sequence"],
                   i["point_cloud"]["sample_idx"]): i for i in infos}
        meta = [{"context_name": by_key[k]["context_name"],
                 "frame_timestamp_micros": by_key[k]["timestamp"]}
                for k in ((d["sequence_name"], d["frame_id"])
                          for d in det["det_annos"])]
        t0 = time.perf_counter()
        recs = submit.build_submission_records(det["det_annos"], meta)
        path = submit.write_submission(recs, out / "submission.bin")
        sub_ms = (time.perf_counter() - t0) * 1e3
        objs = waymo_metrics_pb2.Objects()
        objs.ParseFromString(path.read_bytes())
        if len(objs.objects) != n_det or len(recs) != n_det:
            raise AssertionError(f"submission: {len(objs.objects)} objects "
                                 f"for {n_det} detections")
        want_boxes = np.concatenate([np.asarray(d["boxes_lidar"])[:, :7]
                                     for d in det["det_annos"]])
        for o, r, b in zip(objs.objects, recs, want_boxes):
            got = [getattr(o.object.box, k) for k in
                   ("center_x", "center_y", "center_z", "length", "width",
                    "height", "heading")]
            if got != b.astype(np.float64).tolist() \
                    or o.score != float(np.float32(r["score"])) \
                    or o.object.type != r["type"] \
                    or (o.context_name, o.frame_timestamp_micros) != \
                    (r["context_name"], r["frame_timestamp_micros"]):
                raise AssertionError(f"submission: an object decoded "
                                     f"unequal: {o} against {r}")
        print(f"[offboard] submission: {n_det} objects, "
              f"{path.stat().st_size} bytes in {sub_ms:.1f} ms, decoded "
              f"back equal (boxes as doubles, scores as float32, types, "
              f"contexts and timestamps)")
    finally:
        os.chdir(cwd)
    total = time.perf_counter() - t_phase
    print(f"[offboard] phase 15 in {total:.1f} s")
    if total > OB_PHASE_S:
        raise AssertionError(f"phase 15 took {total:.1f} s, over "
                             f"{OB_PHASE_S:.0f}")
    return launches


# phase 16: data parallelism on the one card.  NCCL puts no two ranks on one
# card, so the 2-rank runs join a gloo group on CUDA tensors, both ranks on
# cuda:0; the NCCL path runs at world size 1.
DP_WORLD = 2
DP_STEPS = 3                 # the 2-rank run's checked steps, then 2 more
DP_PHASE_S = 300.0
# test_det --data_parallel against phase 13's result.pkl: the same frames in
# the same order and as many boxes; boxes (m, rad) and scores within this.
# Each rank predicts the pairs of frames phase 13 predicts, through the same
# kernels, so the bits should agree; the bound leaves room only for cuDNN
# picking another algorithm while two processes share the card
DP_BOX_TOL = 1e-4


def _kernel_spans(prof):
    """The card's kernel intervals of a torch.profiler run on the
    profiler's own clock (us), which every process on a host shares, and
    the run's start there."""
    base = prof.profiler.kineto_results.trace_start_ns() / 1e3
    return base, [(base + e.time_range.start, base + e.time_range.end)
                  for e in prof.events() if e.device_type.name == "CUDA"]


def _union_us(spans):
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def dp_tiny_grads(model, batch, trainer=None):
    """The tiny model's loss, its (rank-averaged, with a trainer under a
    group) gradient and BN running statistics after one forward and
    backward on `batch`."""
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(**batch)
    loss.backward()
    if trainer is not None:
        trainer.average_gradients()
    return (float(loss.detach()),
            {k: p.grad.detach().clone() for k, p in model.named_parameters()},
            {k: b.detach().clone() for k, b in model.named_buffers()})


def dp_rank(rank, world, device, tmp, yaml_path, det_ckpt):
    """One rank of phase 16's gloo group (a spawned process, on cuda:0):
    the tiny float32 model's gradient on this rank's sample; train_det on
    phase 12's tree to DP_STEPS steps with the ranks compared bit for bit
    after each, then resumed for 2 more under torch.profiler; test_det
    --data_parallel on phase 12's checkpoint.  Writes its readings to
    tmp/rank<r>.pt."""
    import torch
    from detzero_tpu_torch.core import mesh
    from detzero_tpu_torch.core.optim import build_optimizer
    from detzero_tpu_torch.parallel.trainer import Trainer
    from detzero_tpu_torch.tools import test_det, train_det
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    tmp = Path(tmp)
    mesh.init_distributed(backend="gloo", device=device,
                          init_method=f"file://{tmp}/rdv", rank=rank,
                          world_size=world)
    os.chdir(REPO)
    out = {}
    try:
        # 3. the tiny float32 model, one sample a rank
        model = build_model(TINY_TRAIN_CFG, TINY_KW, torch.float32, device)
        batch = {k: v[rank:rank + 1] for k, v in
                 tiny_train_batch(TINY_TRAIN_DRAWS[0], device).items()}
        trainer = Trainer(model, build_optimizer(FLAGSHIP_OPT, 2, model))
        out["tiny"] = [x if isinstance(x, float) else
                       {k: v.cpu() for k, v in x.items()}
                       for x in dp_tiny_grads(model, batch, trainer)]
        del model, trainer
        torch.cuda.empty_cache()

        # 2. train_det at the flagship's width, each step checked
        args = ["--cfg_file", str(yaml_path), "--device", str(device),
                "--workers", "0", "--output_dir", str(tmp / "output"),
                "--log_every", "1"]
        steps, step = [], Trainer.step

        def checked(self, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(self, b)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "loss": float(res[0]), "gnorm": float(res[2]),
                          "mismatch": self.replica_mismatch()})
            return res

        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        Trainer.step = checked
        try:
            trainer = train_det.main(args + ["--max_steps", str(DP_STEPS)])
        finally:
            Trainer.step = step
        torch.cuda.synchronize()
        out["train_counts"] = read_counts()
        out["steps"] = steps
        del trainer
        # resumed for 2 steps under torch.profiler, unchecked
        reset_counts()
        fit = Trainer.fit

        def profiled(self, *a, **kw):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = fit(self, *a, **kw)
                torch.cuda.synchronize()
                out["fit_ms"] = (time.perf_counter() - t0) * 1e3
            out["fit_start"], out["spans"] = _kernel_spans(prof)
            return res

        Trainer.fit = profiled
        try:
            trainer = train_det.main(args + ["--max_steps",
                                             str(DP_STEPS + 2)])
        finally:
            Trainer.fit = fit
        torch.cuda.synchronize()
        out["resumed_counts"] = read_counts()
        out["step_count"] = trainer.step_count
        out["final_mismatch"] = trainer.replica_mismatch()
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        out["state"] = {k: v.cpu() for k, v in
                        trainer.model.state_dict().items()}
        del trainer
        torch.cuda.empty_cache()

        # 4. test_det --data_parallel on phase 12's checkpoint
        reset_counts()
        res = test_det.main([
            "--data_parallel", "--cfg_file", str(yaml_path), "--device",
            str(device), "--workers", "2", "--output_dir",
            str(tmp / "output"), "--ckpt", str(det_ckpt), "--save_to_file",
            "--set", *DET_SET])
        torch.cuda.synchronize()
        out["test_counts"] = read_counts()
        out["test"] = None if res is None else {
            "path": str(res["result_path"]), "step": res["step"],
            "timings": res["timings"]}
        torch.save(out, tmp / f"rank{rank}.pt")
        mesh.barrier()
    finally:
        mesh.shutdown()


def spawn_ranks(fn, world, timeout_s, *args):
    """Runs fn(rank, world, *args) in `world` spawned processes; raises
    with a rank's traceback when one fails, or after timeout_s."""
    import torch.multiprocessing as tmp_mp

    ctx = tmp_mp.start_processes(fn, args=(world, *args), nprocs=world,
                                 join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"{world} ranks outlasted {timeout_s:.0f} "
                                 f"s")


def nccl_one_rank(device, tmp, yaml_path):
    """Phase 16 (1): train_det to DP_STEPS steps with no process group,
    then again as world size 1 of an NCCL group: the metrics and the
    final checkpoint must be equal bit for bit.  cuDNN runs deterministic
    in both, so two runs of the one step may be compared at all."""
    import torch
    from detzero_tpu_torch.core import mesh
    from detzero_tpu_torch.core.checkpoint import CheckpointManager
    from detzero_tpu_torch.tools import train_det

    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("none", "nccl"):
            out = Path(tmp) / f"nccl_{name}"
            if name == "nccl":
                mesh.init_distributed(backend="nccl", device=device,
                                      init_method=f"file://{tmp}/nccl_rdv",
                                      rank=0, world_size=1)
            try:
                trainer = train_det.main([
                    "--cfg_file", str(yaml_path), "--device", str(device),
                    "--workers", "0", "--output_dir", str(out),
                    "--log_every", "1", "--max_steps", str(DP_STEPS)])
                if (trainer.mesh.group is None) != (name == "none"):
                    raise AssertionError(f"{name}: the trainer's group is "
                                         f"{trainer.mesh.group}")
                ckpt = trainer.ckpt.ckpt_dir
                del trainer
            finally:
                mesh.shutdown()
            lines = [json.loads(x) for x in
                     (ckpt / "metrics.jsonl").read_text().splitlines()]
            runs[name] = ([(x["loss"], x["gnorm"]) for x in lines],
                          CheckpointManager(ckpt).restore_any()[0])
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m0, c0), (m1, c1) = runs["none"], runs["nccl"]
    same = m0 == m1 and c0["model"].keys() == c1["model"].keys() and all(
        torch.equal(v, c1["model"][k]) for k, v in c0["model"].items())
    for i in c0["optimizer"]["state"]:
        for k, v in c0["optimizer"]["state"][i].items():
            w = c1["optimizer"]["state"][i][k]
            same = same and (torch.equal(v, w) if torch.is_tensor(v)
                             else v == w)
    print(f"[data parallel] NCCL world 1 against no group, {DP_STEPS} "
          f"steps of train_det: (loss, gnorm) " + "; ".join(
              f"{a[0]:.6f}, {a[1]:.6f} | {b[0]:.6f}, {b[1]:.6f}"
              for a, b in zip(m0, m1))
          + f"; parameters, buffers and optimizer state bit-equal: {same}")
    if not same:
        raise AssertionError("train_det under an NCCL group of one rank "
                             "differs from the run without a group")


def run_data_parallel(device, tmp, yaml_path, det_ckpt, phase13_result):
    """Phase 16 in the directory `tmp`: (1) NCCL at world size 1 against
    no group; (2)-(4) DP_WORLD gloo ranks on the card (dp_rank): the tiny
    float32 gradient against one process on both samples, train_det at
    the flagship's width with the ranks bit-equal after every step, and
    test_det --data_parallel against phase 13's result.pkl.  Returns
    {kernel name: launches} of the 2-rank runs (train_det and test_det),
    summed over the ranks."""
    import pickle

    import torch
    from detzero_tpu_torch.tools import common

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    tmp = Path(tmp)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        nccl_one_rank(device, tmp, yaml_path)
        cfg = common.load_config(common.base_parser("").parse_args(
            ["--cfg_file", str(yaml_path)]))
        n_frames = TREE_FRAMES
        per_rank_batch = int(cfg["OPTIMIZATION"]["BATCH_SIZE_PER_DEVICE"])
    finally:
        os.chdir(cwd)

    t0 = time.perf_counter()
    spawn_ranks(dp_rank, DP_WORLD, DP_PHASE_S, str(device), str(tmp),
                str(yaml_path), str(det_ckpt))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(DP_WORLD)]

    # (3) the tiny model: DP_WORLD ranks x 1 sample against one process x
    # DP_WORLD samples, on the card
    model = build_model(TINY_TRAIN_CFG, TINY_KW, torch.float32, device)
    loss1, grads1, stats1 = dp_tiny_grads(
        model, tiny_train_batch(TINY_TRAIN_DRAWS[0], device))
    del model
    loss2 = sum(r["tiny"][0] for r in ranks) / DP_WORLD
    agree = grad_agreement(grads1, ranks[0]["tiny"][1])
    stat_err = max(float((ranks[0]["tiny"][2][k] - v.cpu()).abs().max())
                   / max(float(v.abs().max()), 1.0)
                   for k, v in stats1.items())
    tiny_equal = all(torch.equal(ranks[0]["tiny"][i][k],
                                 ranks[1]["tiny"][i][k])
                     for i in (1, 2) for k in ranks[0]["tiny"][i])
    print(f"[data parallel] tiny float32, {DP_WORLD} gloo ranks x 1 sample "
          f"against 1 process x {DP_WORLD}: loss {loss2:.6f} against "
          f"{loss1:.6f} (rel {abs(loss2 - loss1) / abs(loss1):.2e}); "
          f"gradient " + ", ".join(f"{k} {v:.4g}" for k, v in agree.items())
          + f"; BN statistics rel {stat_err:.2e}; ranks bit-equal "
          f"{tiny_equal}")
    if not (abs(loss2 - loss1) <= 1e-5 * abs(loss1) and stat_err <= 1e-5
            and tiny_equal and agree["out_share"] <= 1e-4
            and agree["min_leaf_share"] >= 0.9
            and abs(agree["norm_ratio"] - 1.0) <= 1e-2):
        raise AssertionError(f"tiny 2-rank check: loss {loss2} against "
                             f"{loss1}, gradient {agree}, BN {stat_err}, "
                             f"ranks equal {tiny_equal}")

    # (2) train_det at the flagship's width
    want = step_launches()
    for r, rk in enumerate(ranks):
        bad = [s["mismatch"] for s in rk["steps"] if s["mismatch"]]
        if len(rk["steps"]) != DP_STEPS or bad or rk["final_mismatch"] or \
                rk["step_count"] != DP_STEPS + 2:
            raise AssertionError(f"rank {r}: {len(rk['steps'])} checked "
                                 f"steps, mismatches {bad} "
                                 f"{rk['final_mismatch']}, ended at step "
                                 f"{rk['step_count']}")
        for key, n in (("train_counts", DP_STEPS), ("resumed_counts", 2)):
            if rk[key] != {k: n * v for k, v in want.items()}:
                raise AssertionError(f"rank {r} {key}: {rk[key]}, expected "
                                     f"{n} x {want}")
        if not all(np.isfinite(s["loss"]) and np.isfinite(s["gnorm"])
                   for s in rk["steps"]):
            raise AssertionError(f"rank {r}: a loss or gnorm not finite")
    if not all(torch.equal(v, ranks[1]["state"][k])
               for k, v in ranks[0]["state"].items()):
        raise AssertionError("the ranks' final states differ")
    if [s["gnorm"] for s in ranks[0]["steps"]] != \
            [s["gnorm"] for s in ranks[1]["steps"]]:
        raise AssertionError("the ranks' gradient norms differ")
    starts = [rk["fit_start"] for rk in ranks]
    ends = [rk["fit_start"] + rk["fit_ms"] * 1e3 for rk in ranks]
    window = max(ends) - min(starts)
    busy = _union_us([sp for rk in ranks for sp in rk["spans"]])
    own = [1.0 - _union_us(rk["spans"]) / (rk["fit_ms"] * 1e3)
           for rk in ranks]
    card_idle = 1.0 - busy / window
    for r, rk in enumerate(ranks):
        ms = [s["ms"] for s in rk["steps"]]
        print(f"[data parallel] {smi}: rank {r}: train_det steps "
              + ", ".join(f"{t:.1f}" for t in ms)
              + f" ms ({per_rank_batch} samples a rank, global batch "
              f"{per_rank_batch * DP_WORLD}); loss " + ", ".join(
                  f"{s['loss']:.4f}" for s in rk["steps"])
              + f"; gnorm " + ", ".join(f"{s['gnorm']:.4f}"
                                        for s in rk["steps"])
              + f"; resumed fit {rk['fit_ms'] / 2:.1f} ms/step over steps "
              f"{DP_STEPS + 1}-{DP_STEPS + 2}, its own idle share "
              f"{own[r]:.3f}; peak memory {rk['peak_gib']:.2f} GiB")
    print(f"[data parallel] {smi}: the card over both ranks' resumed fit "
          f"(the union of their kernels): busy {busy / 1e3:.1f} of "
          f"{window / 1e3:.1f} ms, idle share {card_idle:.3f}; peak memory {sum(r['peak_gib'] for r in ranks):.2f}"
          f" GiB summed over the ranks; parameters, optimizer state and BN "
          f"buffers bit-equal across the ranks after each of {DP_STEPS} "
          f"steps and at step {DP_STEPS + 2}")
    if not 0.0 <= card_idle <= 1.0:
        print("[data parallel] the ranks' profiler clocks disagree: the "
              "card's idle share over both is not measured")

    # (4) test_det --data_parallel against phase 13's result
    per_sample = {"stream_rowpad_feats": 1, "rowpad_conv_fused": 20,
                  "rowpad_nbr": NBR_LAUNCHES, "nms_walk": 1}
    test_want = dict.fromkeys(COUNTERS, 0)
    test_want.update({k: v * n_frames // DP_WORLD
                      for k, v in per_sample.items()})
    if ranks[1]["test"] is not None or ranks[0]["test"] is None:
        raise AssertionError("test_det returned on a rank other than 0, or "
                             "not on rank 0")
    for r, rk in enumerate(ranks):
        if rk["test_counts"] != test_want:
            raise AssertionError(f"rank {r} test_det launches "
                                 f"{rk['test_counts']}, expected "
                                 f"{test_want}")
    with open(ranks[0]["test"]["path"], "rb") as f:
        dp = pickle.load(f)
    with open(phase13_result, "rb") as f:
        one = pickle.load(f)
    ids = [(d["sequence_name"], d["frame_id"]) for d in dp]
    if ids != [(d["sequence_name"], d["frame_id"]) for d in one] or \
            [len(d["name"]) for d in dp] != [len(d["name"]) for d in one]:
        raise AssertionError("test_det --data_parallel: frames or box counts "
                             "differ from phase 13's")
    box_err = max((float(np.abs(a["boxes_lidar"] - b["boxes_lidar"]).max())
                   for a, b in zip(dp, one) if len(a["name"])), default=0.0)
    score_err = max((float(np.abs(a["score"] - b["score"]).max())
                     for a, b in zip(dp, one) if len(a["name"])),
                    default=0.0)
    names_equal = all(np.array_equal(a["name"], b["name"])
                      for a, b in zip(dp, one))
    t = ranks[0]["test"]["timings"]
    wall = t["load_s"] + t["predict_s"] + t["wbf_s"]
    print(f"[data parallel] {smi}: test_det --data_parallel on "
          f"{DP_WORLD} ranks, checkpoint step {ranks[0]['test']['step']}: "
          f"{len(dp)} frames, {sum(len(d['name']) for d in dp)} boxes; "
          f"rank 0 {t['samples']} samples at {t['samples'] / wall:.3f} "
          f"frames/s; against phase 13: frames and counts equal, names "
          f"equal {names_equal}, boxes max err {box_err:.3g}, scores "
          f"{score_err:.3g} (bound {DP_BOX_TOL})")
    if not (names_equal and box_err <= DP_BOX_TOL
            and score_err <= DP_BOX_TOL):
        raise AssertionError("test_det --data_parallel differs from phase "
                             "13's result")
    total = time.perf_counter() - t_phase
    print(f"[data parallel] phase 16 in {total:.1f} s (the ranks "
          f"{ranks_s:.1f} s)")
    if total > DP_PHASE_S:
        raise AssertionError(f"phase 16 took {total:.1f} s, over "
                             f"{DP_PHASE_S:.0f}")
    return {k: sum(rk["train_counts"][k] + rk["resumed_counts"][k]
                   + rk["test_counts"][k] for rk in ranks)
            for k in COUNTERS}


# phase 17: the synthetic quality ladder (DET -> +TRK -> +GRM/PRM -> +CRM)
# through detzero_tpu_torch.tools.{train_det,ladder_synthetic,train_refine}
# at the width of configs/det_model_cfgs/centerpoint_synthetic_v3.yaml and
# configs/ref_model_cfgs/synthetic_{grm,prm,crm}.yaml; the depth is cut to
# LADDER_DET_STEPS detector steps, LADDER_SEQS sequences a seed and
# LADDER_REFINE_STEPS refiner steps (the reference's recipe: 20,000 steps,
# 24 train and 8 val sequences, 1,500 refiner steps).
LADDER_CFG = "configs/det_model_cfgs/centerpoint_synthetic_v3.yaml"
LADDER_DET_STEPS = 300
LADDER_PROFILED_STEPS = 5    # the last detector steps, under torch.profiler
LADDER_WARMUP_STEPS = 10     # detector steps left out of ms/step
LADDER_SEQS = 2
LADDER_TRAIN_SEED = 0
LADDER_VAL_SEED = 1234
LADDER_REFINE_STEPS = 4
LADDER_CPU_FRAMES = 2
# the trained detector's heads, card against CPU: 5e-3 * max(|ref|, 1),
# about 5x the worst error read on the card (9e-4 * max(|ref|, 1), PERF.md)
LADDER_CPU_TOL = 5e-3
LADDER_GIOU_TOL = 1e-4
LADDER_PHASE_S = 240.0
# launches a detector step at batch 1 and a predicted sample
LADDER_STEP = {"stream_rowpad_feats": 1, "rowpad_conv": 39,
               "rowpad_conv_dw": 20, "boxes_iou_bev_pairwise": 2,
               "rowpad_nbr": NBR_LAUNCHES}
LADDER_SAMPLE = {"stream_rowpad_feats": 1, "rowpad_conv_fused": 20,
                 "rowpad_nbr": NBR_LAUNCHES, "nms_walk": 1}


def metrics_ms(ckpt_dir, first):
    """ms_per_it of the metrics.jsonl lines of `ckpt_dir` from step
    `first` on, with the steps' count."""
    lines = [json.loads(x) for x in
             (Path(ckpt_dir) / "metrics.jsonl").read_text().splitlines()]
    if not all(np.isfinite(v) for x in lines for v in x.values()):
        raise AssertionError(f"{ckpt_dir}/metrics.jsonl holds a value that "
                             f"is not finite")
    ms = [x["ms_per_it"] for x in lines if x["step"] >= first]
    return sum(ms) / max(len(ms), 1), len(lines)


def check_ladder_card_cpu(cfg, ckpt, device):
    """The trained detector's heads on LADDER_CPU_FRAMES val frames, the
    card (K1, K2 in bf16, K8) against the CPU (plain versions), both
    float32 models, within LADDER_CPU_TOL * max(|ref|, 1) (phase 4's tiny
    check allows 5e-2 on random weights)."""
    import torch
    from detzero_tpu_torch.core.checkpoint import CheckpointManager
    from detzero_tpu_torch.tools import common, ladder_synthetic

    models = []
    for dev in ("cpu", device):
        m = common.build_detector(cfg, dev, dtype=torch.float32)
        CheckpointManager(ckpt).restore(m)
        models.append(m)
    ds = ladder_synthetic.build_synthetic(cfg, LADDER_VAL_SEED, 1)
    worst = 0.0
    t0 = time.perf_counter()
    for i in range(LADDER_CPU_FRAMES):
        s = ds[i]
        p = torch.from_numpy(s["points"])
        v = torch.from_numpy(s["points_valid"])
        with torch.no_grad():
            ref = models[0].forward_one(p, v)
            got = models[1].forward_one(p.to(device), v.to(device))
        for r, g in zip(ref, got):
            for k in r:
                err = max_abs(g[k].float().cpu(), r[k].float())
                tol = LADDER_CPU_TOL * max(float(r[k].abs().max()), 1.0)
                worst = max(worst, err / tol)
                if not err <= tol:
                    raise AssertionError(f"ladder detector frame {i} head "
                                         f"{k}: card vs CPU {err} > {tol}")
    print(f"[ladder] trained detector card vs CPU on {LADDER_CPU_FRAMES} "
          f"val frames (seed {LADDER_VAL_SEED}): heads within "
          f"{LADDER_CPU_TOL:g} * max(|ref|, 1), worst err/tol {worst:.3f} "
          f"({time.perf_counter() - t0:.1f} s)")


def check_giou(device):
    """boxes_giou3d on 1000 x 1000 clustered 3D boxes on the card (K7 and
    the hull) against the same function on K7's plain version, within
    LADDER_GIOU_TOL: K7 is held to 1e-5 of the largest area (phase 8), and
    the GIoU divides the overlap times a height by a union no smaller
    than a tenth of that area times the height.  Then iou3d.boxes_iou_bev
    (K3) against the reference's ov / max(a + b - ov, 1e-6) on K7's
    overlap."""
    from unittest import mock

    import torch
    from detzero_tpu_torch.ops import iou3d, iou_bev

    bev = clustered_boxes(device)
    g = torch.Generator().manual_seed(5)
    zh = torch.rand((bev.shape[0], 2), generator=g).to(device)
    boxes = torch.stack([bev[:, 0], bev[:, 1], zh[:, 0] - 0.5, bev[:, 2],
                         bev[:, 3], zh[:, 1] * 1.5 + 0.5, bev[:, 4]], 1)
    got = iou3d.boxes_giou3d(boxes, boxes)
    with mock.patch.object(iou3d, "boxes_overlap_bev",
                           iou_bev.boxes_overlap_bev_plain):
        ref = iou3d.boxes_giou3d(boxes, boxes)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    ms = time_ms(lambda: iou3d.boxes_giou3d(boxes, boxes), iters=3)
    finite = bool(torch.isfinite(got).all())
    print(f"[ladder] boxes_giou3d {tuple(got.shape)} on the card: "
          f"max_abs_err {err:.3g} (tol {LADDER_GIOU_TOL:g}) against K7's "
          f"plain version, range [{float(got.min()):.4f}, "
          f"{float(got.max()):.4f}], {ms:.3f} ms")
    # the reference's union height (min(amax, bmax) - min(amin, bmin))
    # lets a GIoU pass 1, so only finiteness bounds it
    if not (err <= LADDER_GIOU_TOL and finite):
        raise AssertionError("boxes_giou3d on the card disagrees with its "
                             "plain version or is not finite")
    ov = iou_bev.boxes_overlap_bev(bev, bev)
    area = bev[:, 2] * bev[:, 3]
    want = ov / torch.clamp(area[:, None] + area[None, :] - ov, min=1e-6)
    err = max_abs(iou3d.boxes_iou_bev(bev, bev), want)
    print(f"[ladder] iou3d.boxes_iou_bev (K3) against ov / max(a + b - ov, "
          f"1e-6) on K7's overlap: max_abs_err {err:.3g} (tol 1e-06)")
    if not err <= 1e-6:
        raise AssertionError("iou3d.boxes_iou_bev disagrees with the "
                             "reference's formula")


def run_ladder_phase(device, tmp):
    """Phase 17 in the directory `tmp`: train_det on the v3 synthetic yaml,
    then run_synthetic_ladder.sh's recipe (`ladder_synthetic.run_recipe`)
    at the cut depth: the refining records of LADDER_SEQS train-seed
    sequences, the nine refiner trainings with CRM's relabel between PRM
    and CRM, the 4-row ladder on LADDER_SEQS val-seed sequences; then the
    trained detector
    card against CPU and boxes_giou3d.  Returns {kernel name: launches}
    of the path (train_det, both run_det calls and everything between)."""
    import torch
    from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
    from detzero_tpu_torch.parallel.trainer import Trainer
    from detzero_tpu_torch.tools import ladder_synthetic, train_det

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    tmp = Path(tmp)
    out = tmp / "output"
    ckpt = out / Path(LADDER_CFG).stem / "default" / "ckpt"
    cwd = os.getcwd()
    os.chdir(REPO)        # the yamls' _BASE_CONFIG_ paths are relative
    try:
        cfg = cfg_from_yaml_file(LADDER_CFG, Config())
        reset_counts()
        # 1. the detector
        torch.cuda.reset_peak_memory_stats(device)
        args = ["--cfg_file", LADDER_CFG, "--device", str(device),
                "--output_dir", str(out), "--log_every", "1"]
        t0 = time.perf_counter()
        train_det.main(args + ["--max_steps", str(LADDER_DET_STEPS
                                                  - LADDER_PROFILED_STEPS)])
        with profiled_calls(Trainer, "fit", {}) as prof:
            train_det.main(args + ["--max_steps", str(LADDER_DET_STEPS)])
        det_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        ms, n_lines = metrics_ms(ckpt, LADDER_WARMUP_STEPS + 1)
        if n_lines != LADDER_DET_STEPS:
            raise AssertionError(f"train_det logged {n_lines} steps, not "
                                 f"{LADDER_DET_STEPS}")
        det_counts = read_counts()
        want = {k: LADDER_DET_STEPS * LADDER_STEP.get(k, 0)
                for k in COUNTERS}
        if det_counts != want:
            raise AssertionError(f"ladder train_det launches {det_counts}, "
                                 f"expected {want}")
        idle = 1.0 - prof["busy_ms"] / prof["wall_ms"]
        print(f"[ladder] {smi}: train_det {LADDER_CFG} to step "
              f"{LADDER_DET_STEPS} in {det_s:.1f} s: {ms:.1f} ms/step over "
              f"steps {LADDER_WARMUP_STEPS + 1}-{LADDER_DET_STEPS}, idle "
              f"share {idle:.3f} over the last {LADDER_PROFILED_STEPS} "
              f"(resumed, under torch.profiler), peak memory {peak:.2f} "
              f"GiB; launches {({k: v for k, v in det_counts.items() if v})}")

        # 2. to 4. run_synthetic_ladder.sh's recipe at the cut depth:
        # records of the train-seed sequences, GRM and PRM, CRM's relabel,
        # CRM, the ladder on the val-seed sequences
        t0 = time.perf_counter()
        rec = ladder_synthetic.run_recipe(
            ckpt, LADDER_CFG, tmp / "ladder", device=str(device),
            train_seq=LADDER_SEQS, val_seq=LADDER_SEQS,
            refine_steps=LADDER_REFINE_STEPS, train_seed=LADDER_TRAIN_SEED,
            val_seed=LADDER_VAL_SEED, out_md="", refine_log_every=1)
        counts = read_counts()
        secs = rec["seconds"]
        labels = ladder_synthetic.iou_gt_of(tmp / "ladder" / "refine_data")
        good = [v for recs in labels.values() for v in recs.values()
                if np.isfinite(v).all() and (v >= 0).any()]
        print(f"[ladder] recipe in {time.perf_counter() - t0:.1f} s: "
              f"refine records of {LADDER_SEQS} train sequences (seed "
              f"{LADDER_TRAIN_SEED}) in {secs['records']:.1f} s: "
              f"{rec['records']['n_records']}; {len(good)} with a finite "
              f"iou_gt matched to GT")
        if not good:
            raise AssertionError("no refining record has a finite iou_gt "
                                 "matched to GT")
        for kind, trained in rec["refiners"].items():
            for cls, r in trained.items():
                if "skipped" in r:
                    print(f"[ladder] {kind} {cls}: {r['skipped']}: not "
                          f"trained")
                    continue
                ms, n_lines = metrics_ms(r["ckpt"], 2)
                print(f"[ladder] {smi}: {kind} {cls}: {n_lines} steps, "
                      f"{ms:.1f} ms/step over steps 2-{LADDER_REFINE_STEPS}")
        trained = {k: [c for c, r in v.items() if "spec" in r]
                   for k, v in rec["refiners"].items()}
        print(f"[ladder] CRM relabel with GRM/PRM of "
              f"{ {k: trained[k] for k in ('grm', 'prm')} }: iou_gt of "
              f"{rec['relabel_changed']} records changed; refiners "
              f"trained in " + ", ".join(f"{k} {secs[k]:.1f} s"
                                         for k in ("grm", "prm", "crm")))
        if (trained["grm"] or trained["prm"]) and not rec["relabel_changed"]:
            raise AssertionError("the CRM relabel changed no iou_gt")
        res = rec["ladder"]
        t = res["timings"]
        n_frames = len(res["det_annos"]) + len(rec["records"]["det_annos"])
        want = {k: want[k] + n_frames * LADDER_SAMPLE.get(k, 0)
                for k in COUNTERS}
        if counts != want:
            raise AssertionError(f"ladder launches {counts}, expected "
                                 f"{want}")
        print(f"[ladder] ladder on {LADDER_SEQS} val sequences (seed "
              f"{LADDER_VAL_SEED}), detector step {LADDER_DET_STEPS}, in "
              f"{secs['ladder']:.1f} s:\n{res['table']}")
        print(f"[ladder] DET mean AP_L2 waymo101 "
              f"{res['waymo101']['mean']['AP_L2']:.4f}")
        for name, r in res["rows"]:
            vals = [r["mean"]["AP_L2"], r["mean"]["APH_L2"]] + [
                r[c]["AP_L2"] for c in ladder_synthetic.CLASSES]
            if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
                raise AssertionError(f"ladder row {name}: {vals} not all "
                                     f"finite in [0, 1]")
        if [name for name, _ in res["rows"]][:2] != ["DET", "+TRK"]:
            raise AssertionError("the ladder lacks its DET and +TRK rows")
        print(f"[ladder] {smi}: run_det {t['frames']} frames in "
              f"{t['load_s'] + t['predict_s']:.2f} s, "
              f"{t['frames'] / (t['load_s'] + t['predict_s']):.2f} frames/s"
              f" (predict {1e3 * t['predict_s'] / t['frames']:.1f} ms a "
              f"frame); stages: " + "; ".join(
                  f"{label} {v['wall_s']:.2f} s (track "
                  f"{v['stages']['track']['total_s']:.2f}, refine "
                  f"{v['stages']['refine']['total_s']:.2f})"
                  for label, v in t.items() if isinstance(v, dict)))
        print(f"[ladder] launches LD (train_det + run_det of {n_frames} "
              f"frames): {({k: v for k, v in counts.items() if v})}")

        # 5. and 6. the trained detector card against CPU; GIoU and K3
        check_ladder_card_cpu(cfg, ckpt, device)
        check_giou(device)
    finally:
        os.chdir(cwd)
    took = time.perf_counter() - t_phase
    print(f"[ladder] phase 17 took {took:.1f} s (limit {LADDER_PHASE_S:.0f})")
    if took > LADDER_PHASE_S:
        raise AssertionError(f"phase 17 took {took:.1f} s, over "
                             f"{LADDER_PHASE_S:.0f}")
    return counts


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

    # 2. build: the CUDA kernels, and beside them the native sweep loader
    # (g++) in a thread
    import threading

    from detzero_tpu_torch import native

    t0 = time.time()
    built = {}
    gxx = threading.Thread(target=lambda: built.update(
        lib=native.build(), s=time.time() - t0))
    gxx.start()
    so = _build.build()
    _build.lib()
    print(f"[build] {so.relative_to(_build.BUILD_ROOT.parent.parent)} in "
          f"{time.time() - t0:.1f} s")
    gxx.join()
    if "lib" not in built:
        native.build()          # raises g++'s error
    native._load()
    print(f"[build] {built['lib'].relative_to(REPO)} in {built['s']:.1f} s")
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
    train_rec, by_path["train_step"], warm, step_ms = run_train(device)
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
    torch.cuda.empty_cache()

    # 12. to 15. in one temporary root, since phase 15 reads phase 12's
    # detector checkpoint and phase 14's refiners
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 12. and 13. the training entry point on a Waymo-layout tree, then
        # the inference entry point and the tracker on its checkpoint
        det_tmp = Path(tmp) / "waymo_tree"
        det_tmp.mkdir()
        det_rec, by_path["train_det"], yaml_path = run_train_det(
            device, step_ms, det_tmp)
        for name, r in det_rec.items():
            rec[name]["train_det"] = r
        torch.cuda.empty_cache()
        by_path.update(run_test_det(device, det_tmp, yaml_path))
        torch.cuda.empty_cache()

        # 14. the refining stage from tracks: the daemon, GRM, PRM and CRM
        ref_tmp = Path(tmp) / "refining"
        ref_tmp.mkdir()
        run_refining(device, ref_tmp)
        torch.cuda.empty_cache()

        # 15. the offboard pipeline from raw records, on phase 12's
        # checkpoint and phase 14's Vehicle refiners
        det_exp = det_tmp / "output" / yaml_path.stem / "default"
        by_path["OB"] = run_offboard_phase(
            device, Path(tmp) / "offboard", det_exp / "ckpt",
            {kind: ref_tmp / "output" / Path(yaml).stem / "default" / "ckpt"
             for kind, yaml in REFINE_CFGS.items()})
        torch.cuda.empty_cache()

        # 16. data parallelism: NCCL at world size 1, then 2 gloo ranks on
        # the card on phase 12's tree and checkpoint
        dp_tmp = Path(tmp) / "data_parallel"
        dp_tmp.mkdir()
        by_path["DP"] = run_data_parallel(device, dp_tmp, yaml_path,
                                          det_exp / "ckpt",
                                          det_exp / "result.pkl")
    torch.cuda.empty_cache()

    # 17. the synthetic quality ladder, in a temporary root of its own
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ladder_") as tmp:
        by_path["LD"] = run_ladder_phase(device, tmp)
    torch.cuda.empty_cache()

    # result lines
    kernels = []
    for name, (src, replaces, *more) in KERNELS.items():
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
        if more:
            kernels[-1]["sources"] = [src, *more]
        if "weighted_ms" in r:
            kernels[-1]["weighted_ms"] = r["weighted_ms"]
        # K3 on the frame's NMS input, K7 on 1000 x 1000 clustered boxes,
        # K10's mask and walk alone and K10 on the clustered boxes, K1, K4
        # and K5 at phase 12's shapes (F = 6)
        for key in ("frame", "big", "mask", "walk", "clustered",
                    "train_det"):
            if key in r:
                kernels[-1][key] = {k: r[key][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms") if k in r[key]}
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

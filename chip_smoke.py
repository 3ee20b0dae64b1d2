#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detzero_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and the exit code is 1:
  1. device: versions, card name and power limit (no CUDA -> exit 1);
  2. build: compile detzero_tpu_torch/csrc/*.cu from this checkout;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes of the flagship path, with stated tolerances
     and CUDA-event times;
  4. predict: flagship CenterPoint (160k points, 40x1504x1504 grid, bf16,
     random weights from a seeded torch.Generator) on the input of
     __graft_entry__.entry(): launch counts of one frame, frames/s over 5
     timed frames after 2 warm-up frames, per-stage times, peak memory; and
     a tiny-geometry check of the card's outputs against the same model on
     the CPU (plain versions, float32), which the CPU tests hold to the JAX
     reference;
  5. training kernels: K4 (rowpad_conv, 'subm'/'down'/'up') and K5
     (rowpad_conv_dw) against their plain versions at the shapes of the
     flagship training step (batch 2), and K6 (matched-pair IoU) on the
     1000 pairs per head that the next training step forms;
  6. train: the flagship training step at batch 2 through Trainer.step
     (adam_onecycle of configs/det_model_cfgs/centerpoint_5sweeps.yaml):
     launch counts of every step, ms/step over 3 timed steps after one
     warm-up step, per-stage times, peak memory; and the tiny-geometry
     training loss and gradient on the card (float32 and bf16) against the
     CPU's on two draws.
The line before the last carries every kernel's numbers as JSON (launches:
the counted predict frame's plus the counted training step's, each path's
own in `launches_by_path`); the last line is {"ok": true, "device": {...}}.
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
}


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


def time_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def masked_table(zmask, c, gen):
    """A random bf16 (ny, nz*c, B) table of a level, zero at the sites its
    zmask (ny, nz, B) marks empty, as the model's tables are."""
    import torch

    t = torch.randn((zmask.shape[0], zmask.shape[1], c, zmask.shape[2]),
                    generator=gen, device=zmask.device)
    return (t * zmask[:, :, None, :]).reshape(zmask.shape[0], -1,
                                              zmask.shape[2]).bfloat16()


def build_model(cfg, kw, dtype, device, seed=0):
    import torch
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    model = CenterPoint(cfg, 3, dtype=dtype, **kw)
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
    rec["stream_rowpad_feats"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    rp_feats = got

    # K2 at four shapes of the path: the stem (cin 5), the L0 subm conv
    # with residual, the L0 -> L1 down conv, the L3 subm conv.  Tolerance
    # 2e-2 * max|ref|: both sides read the same bf16 inputs and round to
    # bf16 once; only the f32 summation order differs.
    def rand_table(lv, c):
        return masked_table(plan[lv]["rp_zmask"], c, gen)

    def case(name, table_in, lv_out, nbr, cin, cout, nz_in, mode, res):
        w = torch.randn((27, cin, cout), generator=gen, device=device) \
            * (27 * cin) ** -0.5
        sc = torch.rand(cout, generator=gen, device=device) + 0.5
        bi = torch.randn(cout, generator=gen, device=device) * 0.1
        zm = plan[lv_out]["rp_zmask"]
        onz = zm.shape[1]
        residual = rand_table(lv_out, cout) if res else None
        ckw = dict(nz=nz_in, cin=cin, cout=cout, out_nz=onz, mode=mode,
                   z_stride=2 if mode == "down" else 1, relu=True)
        a = (table_in, nbr, w, sc, bi, zm, residual)
        ref = rowpad_conv.rowpad_conv_fused_plain(*a, **ckw)
        got = rowpad_conv.rowpad_conv_fused(*a, **ckw)
        torch.cuda.synchronize()
        err = max_abs(got, ref)
        tol = 2e-2 * max(float(ref.float().abs().max()), 1e-3)
        ms = time_ms(lambda: rowpad_conv.rowpad_conv_fused(*a, **ckw))
        pms = time_ms(lambda: rowpad_conv.rowpad_conv_fused_plain(*a, **ckw),
                      iters=2, warmup=1)
        print(f"[kernels] rowpad_conv_fused {name} in {tuple(a[0].shape)} "
              f"out {tuple(got.shape)}: max_abs_err {err:.3g} (tol "
              f"{tol:.3g}), {ms:.3f} ms vs plain {pms:.3f} ms")
        if not err <= tol:
            raise AssertionError(f"rowpad_conv_fused {name} disagrees")
        return dict(case=name, max_abs_err=err, tol=tol, ms=ms, plain_ms=pms)

    nz3 = plan[3]["rp_zmask"].shape[1]
    cases = [
        case("stem L0 5->16", rp_feats, 0, plan[0]["rp_nbr"], 5, 16, nz,
             "subm", False),
        case("L0 subm 16->16 +res", rand_table(0, 16), 0, plan[0]["rp_nbr"],
             16, 16, nz, "subm", True),
        case("down L0->L1 16->32", rand_table(0, 16), 1,
             plan[0]["rp_down_nbr"], 16, 32, nz, "down", False),
        case("L3 subm 128->128 +res", rand_table(3, 128), 3,
             plan[3]["rp_nbr"], 128, 128, nz3, "subm", True),
    ]
    # K2's record: the worst error and the summed times of its four shapes
    rec["rowpad_conv_fused"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=sum(c["ms"] for c in cases),
        plain_ms=sum(c["plain_ms"] for c in cases), cases=cases)

    # K3 on 1000 x 1000 boxes with real overlaps: 200 clusters of 5
    # jittered boxes.  Both versions round every operation alike; the
    # tolerance 1e-5 absolute covers sin/cos differing in the last ulp.
    g = torch.Generator().manual_seed(2)
    base = torch.rand((200, 1, 5), generator=g)
    base = base * torch.tensor([80.0, 80.0, 4.0, 2.0, 6.283]) \
        + torch.tensor([-40.0, -40.0, 1.0, 1.0, -3.1416])
    jit = torch.randn((200, 5, 5), generator=g) \
        * torch.tensor([0.3, 0.3, 0.2, 0.1, 0.2])
    boxes = (base + jit).reshape(1000, 5)
    boxes[:, 2:4] = boxes[:, 2:4].abs() + 0.2
    boxes = boxes.to(device)
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
    rec["boxes_iou_bev"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

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
    rec["nms_walk"] = dict(max_abs_err=float(diff), ms=ms, plain_ms=pms)
    return rec


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


def stage_times(model, p, v, frames=3):
    """Per-stage ms of one frame (mean over `frames`), CUDA events between
    the stages that predict() composes."""
    import torch
    from detzero_tpu_torch.models.detection.backbone3d_pallas import (
        stack_plans,
    )

    names = ["table", "vfe (K1)", "plan", "backbone3d (K2)",
             "bev+head", "decode+nms (K3, walk)"]
    tot = np.zeros(len(names))
    for _ in range(frames):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        with torch.no_grad():
            ev[0].record()
            table = model.build_table(p, v)
            ev[1].record()
            rp = model.vfe(table["stream"])
            ev[2].record()
            plan = stack_plans([model.build_plan(table)])
            ev[3].record()
            bev = model.backbone3d(rp, plan)[0]
            ev[4].record()
            preds = model.bev_head(bev)
            ev[5].record()
            model.decode(preds)
            ev[6].record()
        torch.cuda.synchronize()
        tot += [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]
    return dict(zip(names, (tot / frames).tolist()))


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
                 "boxes_iou_bev": 1, "nms_walk": 1})
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
    st = stage_times(model, p[0], v[0])
    print("[predict] stage ms: " + ", ".join(
        f"{k} {t:.2f}" for k, t in st.items()))
    return launches


def check_tiny(device):
    """The card (kernels, bf16) against the CPU (plain versions, f32) on the
    tiny geometry with the same weights.  bf16 rounds at every layer (2^-8
    relative); over the ~30 layers of the path that grows to about 2e-2,
    so the tolerance is 5e-2 * max(|ref|, 1)."""
    import torch

    pts, pv = entry_points(2048, seed=0)
    pts[..., :2] *= 6.0 / 70.0
    pts[..., 2] = np.clip(pts[..., 2], -1.8, 1.8)
    cpu = build_model(TINY_CFG, TINY_KW, torch.float32, "cpu")
    gpu = build_model(TINY_CFG, TINY_KW, torch.bfloat16, device)
    gpu.load_state_dict(cpu.state_dict())
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
    """Phase 5: K4 and K5 against their plain versions on the card, at the
    shapes of the flagship training step: the batch's tables and maps
    stacked along the BEV-row axis, as CenterPoint.loss runs them.  Returns
    {name: record}."""
    import torch
    from detzero_tpu_torch.ops import rowpad_conv

    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        rp_feats, plan = model.prepare(batch["points"],
                                       batch["points_valid"])
    nz = model.grid_zyx[0]

    def rand_table(lv, c):
        return masked_table(plan[lv]["rp_zmask"], c, gen)

    def conv_case(name, table, nbr, lv_out, cin, cout, nz_in, mode):
        """K4 with the output level's zmask, on bf16-rounded weights, so
        both sides multiply the same values: 2e-2 * max|ref| for f32 sums
        in another order and one bf16 rounding of the output."""
        zm = plan[lv_out]["rp_zmask"]
        w = (torch.randn((27, cin, cout), generator=gen, device=device)
             * (27 * cin) ** -0.5).bfloat16().float()
        ckw = dict(nz=nz_in, cin=cin, cout=cout, out_nz=zm.shape[1],
                   mode=mode, z_stride=2 if mode == "down" else 1)
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
        torch.cuda.empty_cache()
        print(f"[train-kernels] rowpad_conv {name} in {tuple(table.shape)} "
              f"out {tuple(got.shape)}: max_abs_err {err:.3g} (tol "
              f"{tol:.3g}), {ms:.3f} ms vs plain {pms:.3f} ms")
        if not err <= tol:
            raise AssertionError(f"rowpad_conv {name} disagrees")
        return dict(case=name, max_abs_err=err, tol=tol, ms=ms, plain_ms=pms)

    def dw_case(name, table, nbr, lv_out, cin, cout, nz_in, mode):
        """K5 with a random output gradient that is zero at empty sites, as
        the model's is: the same bf16 products summed in f32 in another
        order, 1e-3 * max|ref|; two launches give the same bits."""
        zm = plan[lv_out]["rp_zmask"]
        d_out = rand_table(lv_out, cout)
        ckw = dict(nz=nz_in, cin=cin, cout=cout, out_nz=zm.shape[1],
                   mode=mode, z_stride=2 if mode == "down" else 1)
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
        torch.cuda.empty_cache()
        print(f"[train-kernels] rowpad_conv_dw {name} table "
              f"{tuple(table.shape)} d_out {tuple(d_out.shape)}: max_abs_err "
              f"{err:.3g} (tol {tol:.3g}), {ms:.3f} ms vs plain {pms:.3f} ms")
        if not err <= tol:
            raise AssertionError(f"rowpad_conv_dw {name} disagrees")
        if not torch.equal(got, again):
            raise AssertionError(f"rowpad_conv_dw {name} differs between "
                                 f"two launches")
        return dict(case=name, max_abs_err=err, tol=tol, ms=ms, plain_ms=pms)

    nz3 = plan[3]["rp_zmask"].shape[1]
    l0_16 = rand_table(0, 16)
    conv = [
        conv_case("L0 subm 16->16", l0_16, plan[0]["rp_nbr"], 0, 16, 16, nz,
                  "subm"),
        conv_case("down L0->L1 16->32", l0_16, plan[0]["rp_down_nbr"], 1,
                  16, 32, nz, "down"),
        # the input gradient of that down conv: L1's 32 channels back to L0
        conv_case("up L1->L0 32->16", rand_table(1, 32),
                  plan[0]["rp_up_nbr"], 0, 32, 16, nz, "up"),
        conv_case("L3 subm 128->128", rand_table(3, 128), plan[3]["rp_nbr"],
                  3, 128, 128, nz3, "subm"),
    ]
    # K5 has no 'up' case (the up conv's weight gradient is the down
    # conv's); the stem, whose kernel trains, takes its place
    dw = [
        dw_case("stem L0 5->16", rp_feats, plan[0]["rp_nbr"], 0, 5, 16, nz,
                "subm"),
        dw_case("L0 subm 16->16", l0_16, plan[0]["rp_nbr"], 0, 16, 16, nz,
                "subm"),
        dw_case("down L0->L1 16->32", l0_16, plan[0]["rp_down_nbr"], 1, 16,
                32, nz, "down"),
        dw_case("L3 subm 128->128", rand_table(3, 128), plan[3]["rp_nbr"],
                3, 128, 128, nz3, "subm"),
    ]
    rec = {}
    for name, cases in (("rowpad_conv", conv), ("rowpad_conv_dw", dw)):
        rec[name] = dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                         ms=sum(c["ms"] for c in cases),
                         plain_ms=sum(c["plain_ms"] for c in cases),
                         cases=cases)

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
        preds = model.network(*model.prepare(batch["points"],
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
    iou = (iou_bev.boxes_iou_bev_pairwise, iou_bev.boxes_iou_bev_pairwise_plain)
    worst, ms, pms, iou_ms, iou_pms = 0.0, 0.0, 0.0, 0.0, 0.0
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
    return dict(max_abs_err=worst, ms=ms, plain_ms=pms)


def train_stage_times(model, optimizer, batch):
    """Per-stage ms of one training step: the stages Trainer.step and
    CenterPoint.loss compose, with CUDA events between them."""
    import torch

    names = ["table+vfe+plan (K1)", "backbone3d fwd (K4)", "bev+head fwd",
             "targets+loss (K6)", "backward (K4, K5)", "optimizer"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    model.train()
    ev[0].record()
    rp, plan = model.prepare(batch["points"], batch["points_valid"])
    ev[1].record()
    bev = model.backbone3d(rp, plan)
    ev[2].record()
    preds = model.bev_head(bev)
    ev[3].record()
    per_sample, _ = model.head_loss(preds, model.targets(
        batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"]))
    loss = per_sample.mean()
    ev[4].record()
    optimizer.zero_grad()
    loss.backward()
    ev[5].record()
    optimizer.step()
    ev[6].record()
    torch.cuda.synchronize()
    model.eval()
    return dict(zip(names, (ev[i].elapsed_time(ev[i + 1])
                            for i in range(6))))


def run_train(device):
    """Phase 5 and 6.  Returns (kernel records of phase 5, {kernel name:
    launches in the counted step})."""
    import torch
    from detzero_tpu_torch.core.optim import build_optimizer
    from detzero_tpu_torch.parallel.trainer import Trainer

    pts, pv = entry_points(batch=TRAIN_BATCH)
    gt = make_gt(TRAIN_BATCH, FLAGSHIP_KW["max_objs"], 48, 60.0)
    batch = train_batch(pts, pv, gt, device)
    model = build_model(FLAGSHIP_CFG, FLAGSHIP_KW, torch.bfloat16, device)
    rec = check_train_kernels(model, batch, device)
    torch.cuda.empty_cache()

    timed = 3
    trainer = Trainer(model, build_optimizer(FLAGSHIP_OPT, timed + 2, model))
    trainer.step(batch)                              # warm-up step
    torch.cuda.synchronize()
    rec["boxes_iou_bev_pairwise"] = check_pairwise(model, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"stream_rowpad_feats": TRAIN_BATCH, "rowpad_conv": 39,
                 "rowpad_conv_dw": 20, "boxes_iou_bev_pairwise": 2})
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
            raise AssertionError(f"train step {i}: launch counts "
                                 f"{launches}, expected {want}")
        if not (torch.isfinite(loss) and torch.isfinite(gnorm)):
            raise AssertionError(f"train step {i}: loss {float(loss)}, "
                                 f"gnorm {float(gnorm)}")
        print(f"[train] step {i}: {times[-1]:.2f} ms, loss "
              f"{float(loss):.4f}, gnorm {float(gnorm):.4f}, lr "
              f"{trainer.optimizer.lr:.3g}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"[train] launches in one step: {launches}")
    print("[train] aux: " + ", ".join(f"{k} {float(v.mean()):.4f}"
                                      for k, v in aux.items()))
    ms = sum(times) / timed
    print(f"[train] flagship batch {TRAIN_BATCH}, {timed} steps: {ms:.2f} "
          f"ms/step ({', '.join(f'{t:.2f}' for t in times)}), "
          f"{1000.0 * TRAIN_BATCH / ms:.3f} samples/s, peak memory "
          f"{peak:.2f} GiB")
    st = train_stage_times(model, trainer.optimizer, batch)
    print("[train] stage ms: " + ", ".join(f"{k} {t:.2f}"
                                           for k, t in st.items()))
    return rec, launches


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
    from detzero_tpu_torch.ops import iou_bev, rowpad_conv

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
                 iou_bev.PAIRWISE_LAUNCHES)
            if name != "cpu" and n != (39, 20, 2):
                raise AssertionError(f"tiny train draw {seed} {name}: K4, "
                                     f"K5, K6 launches {n}")
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
    for line in (so.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

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
    train_rec, by_path["train_step"] = run_train(device)
    rec.update(train_rec)
    torch.cuda.empty_cache()
    check_tiny_train(device)

    # 7. result lines
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = rec[name]
        counts = {path: c[name] for path, c in by_path.items() if c[name]}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(counts.values()),
                        "launches_by_path": counts,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

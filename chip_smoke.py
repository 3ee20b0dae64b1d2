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
     reference.
The line before the last carries every kernel's numbers as JSON; the last
line is {"ok": true, "device": {...}}.
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

KERNELS = {
    "stream_rowpad_feats": ("detzero_tpu_torch/csrc/stream_vfe.cu",
                            "detzero_tpu/ops/pallas_pillar.py:966"),
    "rowpad_conv_fused": ("detzero_tpu_torch/csrc/rowpad_conv.cu",
                          "detzero_tpu/ops/pallas_pillar.py:638"),
    "boxes_iou_bev": ("detzero_tpu_torch/csrc/iou_bev.cu",
                      "detzero_tpu/ops/pallas_iou.py:186"),
    "nms_walk": ("detzero_tpu_torch/csrc/nms_walk.cu",
                 "detzero_tpu/ops/pallas_iou.py:247"),
}


def entry_points(n_points=160_000, seed=0):
    """__graft_entry__.entry()'s input (batch 1), rebuilt without jax."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-70, 70, (1, n_points, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.5, 3.5, (1, n_points))
    return pts, np.ones((1, n_points), bool)


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
        zm = plan[lv]["rp_zmask"]
        t = torch.randn((zm.shape[0], zm.shape[1], c, zm.shape[2]),
                        generator=gen, device=device)
        return (t * zm[:, :, None, :]).reshape(zm.shape[0], -1,
                                               zm.shape[2]).bfloat16()

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


def counters():
    from detzero_tpu_torch.ops import iou_bev, nms, rowpad_conv, stream_vfe

    return {"stream_rowpad_feats": stream_vfe, "rowpad_conv_fused":
            rowpad_conv, "boxes_iou_bev": iou_bev, "nms_walk": nms}


def stage_times(model, p, v, frames=3):
    """Per-stage ms of one frame (mean over `frames`), CUDA events between
    the stages that predict() composes."""
    import torch

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
            plan = model.build_plan(table)
            ev[3].record()
            bev = model.backbone3d(rp, plan)
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

    mods = counters()
    for m in mods.values():
        m.LAUNCHES = 0
    out = model.predict(p, v)                        # the counted frame
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    print(f"[predict] launches in one frame: {launches}")
    want = {"stream_rowpad_feats": 1, "rowpad_conv_fused": 20,
            "boxes_iou_bev": 1, "nms_walk": 1}
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
    launches = run_predict(device)
    check_tiny(device)

    # 5. result lines
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = rec[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
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

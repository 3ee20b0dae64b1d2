#!/usr/bin/env python3
"""torch.profiler trace of the port's two-stage flagship on one NVIDIA GPU.

    python3 chip_profile.py

Builds the kernels, then profiles one predict frame (batch 1) and one
training step (batch 2) of the two-stage flagship of chip_smoke.py
(FLAGSHIP2_CFG, the same input, weights and optimizer), each after warm-up.
For each it prints the wall time, the host's enqueue time, the device's
busy time (the union of the kernels' intervals on the card), the idle share
1 - busy / wall, the device time and launches of the row-pad conv kernels
(K2, K4, K5, each summed over its template instances), and the kernels
with the most device time.  Exits 1 without CUDA.
"""

from __future__ import annotations

import re
import sys
import time

# the row-pad conv kernels by their names in the trace: K2 and K4 are one
# template whose second argument (the epilogue) tells them apart; K5 is its
# kernel and the fixed-order sum of its chunks
CONV_KERNELS = {
    "K2": r"rowpad_conv_mma_kernel<\d+, true",
    "K4": r"rowpad_conv_mma_kernel<\d+, false|rowpad_conv_f32_kernel",
    "K5": r"rowpad_conv_dw_kernel|sum_chunks_kernel",
}


def busy_ms(prof):
    """The union of the device kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type.name == "CUDA")
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile(name, fn, top=15):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    wall = (t2 - t0) * 1e3
    busy = busy_ms(prof)
    n_kernels = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    print(f"[profile] {name}: wall {wall:.2f} ms, host enqueue "
          f"{(t1 - t0) * 1e3:.2f} ms, device busy {busy:.2f} ms in "
          f"{n_kernels} kernels, idle share {1.0 - busy / wall:.3f} "
          f"(profiler on)")
    conv = {k: [0.0, 0] for k in CONV_KERNELS}
    for e in prof.events():
        for k, pattern in CONV_KERNELS.items():
            if e.device_type.name == "CUDA" and re.search(pattern, e.name):
                conv[k][0] += (e.time_range.end - e.time_range.start) / 1e3
                conv[k][1] += 1
    print(f"[profile] {name}: conv kernels' device time " + ", ".join(
        f"{k} {ms:.2f} ms in {n} kernels" for k, (ms, n) in conv.items()))
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=top, max_name_column_width=60))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from detzero_tpu_torch import _build

    device = torch.device("cuda", 0)
    print(f"[device] {cs.nvidia_smi_line()}")
    _build.lib()

    pts, pv = cs.entry_points()
    model = cs.build_model(cs.FLAGSHIP2_CFG, cs.FLAGSHIP_KW, torch.bfloat16,
                           device)
    p = torch.from_numpy(pts).to(device)
    v = torch.from_numpy(pv).to(device)
    for _ in range(2):
        model.predict(p, v)
    profile("two_stage_predict", lambda: model.predict(p, v))

    batch = cs.flagship_train_batch(device)
    batch["generator"] = torch.Generator(device=device).manual_seed(5)
    trainer = cs.flagship_trainer(model)
    trainer.step(batch)
    profile("two_stage_train_step", lambda: trainer.step(batch))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The traced window, three stretches over the same batches or steps:

1. plain: no profiler, a CUDA event at every stage boundary the program
   marks (`CenterPoint.stage_hook`, `Trainer.stage_hook`) and at the end
   of each batch.  Its stage times and its host-clock seconds are what the
   per-layer times, the idle share and the step's share of the peak read:
   the events cost microseconds, where tracing the host's ops slows a
   host-paced batch by half or more.
2. device trace: `torch.profiler` with the device's activity alone.  It
   gives the device's busy time (the union of its kernels' intervals), the
   traced window's seconds (longer than the plain stretch by the
   profiler's own cost), each conv kernel's device time by name and the
   kernels that took most time.
3. host trace: the host's ops and the device's over the first few items,
   read only for the longest idle gaps by the host op that ran during
   them (its own cost widens them).
"""

from __future__ import annotations

import bisect
import re
import time

import torch

# the row-pad conv kernels by their names in the trace: K2 and K4 are one
# template whose second argument (the epilogue) tells them apart; K5 is its
# kernel and the fixed-order sum of its chunks
CONV_KERNELS = {
    "K2": r"rowpad_conv_mma_kernel<\d+, true",
    "K4": r"rowpad_conv_mma_kernel<\d+, false|rowpad_conv_f32_kernel",
    "K5": r"rowpad_conv_dw_kernel|sum_chunks_kernel",
}
TOP = 10


class StageEvents:
    """A stage hook: a CUDA event where each stage begins; `ms()` sums each
    stage's time (to the next mark) over its repeats.  The harness marks
    "end" after each batch, which ends the batch's last stage."""

    def __init__(self):
        self.marks = []

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def ms(self):
        torch.cuda.synchronize()
        out = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if name != "end":
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def _union(spans):
    """Merged (start, end) intervals of `spans`."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def traced(run_one, n, hooked, n_host=2):
    """Runs run_one(i) for i < n plain under the stage events, again for
    i < n under the device's trace, and for i < n_host under the host's.
    Returns the record: plain_s, stage_ms, window_s, busy_s, kernel_s,
    breakdown."""
    from torch.profiler import ProfilerActivity, profile

    ev = StageEvents()
    for obj in hooked:
        obj.stage_hook = ev
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        run_one(i)
        ev("end")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for obj in hooked:
        obj.stage_hook = None
    stage_ms = ev.ms()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run_one(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels = _device_ops(prof.events())
    busy = _union((e.time_range.start, e.time_range.end) for e in kernels)
    busy_s = sum(e - s for s, e in busy) / 1e6
    kernel_s = {k: sum(e.time_range.end - e.time_range.start
                       for e in kernels if re.search(pat, e.name)) / 1e6
                for k, pat in CONV_KERNELS.items()}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_host):
            run_one(i)
        torch.cuda.synchronize()
    events = prof.events()
    host_busy = _union((e.time_range.start, e.time_range.end)
                       for e in _device_ops(events))
    host = [e for e in events if e.device_type.name == "CPU"]
    return {"plain_s": plain_s, "stage_ms": stage_ms,
            "window_s": window_s, "busy_s": busy_s, "kernel_s": kernel_s,
            "breakdown": {"device_ops": [list(x) for x in device_ops],
                          "idle_gaps": _idle_gaps(host_busy, host)}}


def _device_ops(events):
    """The device's operations; user annotations (the optimizer's step
    range, record_function ranges) are copied onto the device's track and
    are no operation."""
    return [e for e in events if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]


def _idle_gaps(busy, host):
    """The idle gaps between the busy intervals, summed by the innermost
    host op running at each gap's middle; the TOP largest."""
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in host)
    starts = [h[0] for h in host]
    by_op = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid)
        name = "(no host op)"
        # the latest-starting op that still runs at mid
        for j in range(i - 1, max(i - 200, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_op[name] = by_op.get(name, 0.0) + (s1 - e0) / 1e6
    return [list(x) for x in sorted(by_op.items(),
                                    key=lambda kv: -kv[1])[:TOP]]

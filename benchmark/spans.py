"""The program's spans against the device trace: which layer's host work the
card waits on.

A fourth traced stretch runs the same batches or steps again with the
program's span recorder on (`detzero_tpu_torch.core.profiling.recording`)
under `torch.profiler` with the device's activity alone, puts the spans on
the trace's clock (`profiling.align`, from clock probes the recording
makes), and links each device op to the host record that launched it by
the trace's correlation id.

The attribution rule (`attribute`): each idle gap on the card is charged to
the innermost span in which the host launched the op that ends the gap:
the host work the card waited for.  A launch in no span is charged to
`outside` (the harness's copy in and its copy out); an op whose launch
record is missing to `unlinked`.  The charges add up to the stretch's idle
time: from its first op's start to its last op's end, less the union of
its ops.

`stretch(run_one, n)` returns the record's new keys, and `{}` where the
program has no recorder.  `METRICS` names the per-layer metrics that read
them and `read` reads one.  `main` runs one cell as `run.py --trace 1`
does, with the recording's on-cost before the harness's three stretches
and this one after them:

    python3 benchmark/spans.py --workload <cell> --seed <n>
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# kernels whose spans the stretch reports by name: K2 the predict's convs,
# K1 the VFE, K10 the NMS walk, K5 the weight gradients and the index
# backward of the (V, 27) gathers
NAMED = {"K2": r"rowpad_conv_mma_kernel<\d+, true",
         "K1": r"stream_vfe",
         "K10": r"nms_walk",
         "K5": r"rowpad_conv_dw_kernel",
         "index_backward": r"indexing_backward_kernel"}
HOST_KINDS = ("cuda_runtime", "cuda_driver")
DEVICE_KINDS = {"kernel": True, "gpu_memcpy": False, "gpu_memset": False}

PLAN = ("table", "plan", "row-pad maps", "vfe", "gather", "stack")
# metric: (entry, what, span names); "wait" sums the spans' waits a batch or
# step, "launches" counts the kernels launched inside the one span name
METRICS = {
    "plan_wait_ms.predict": ("predict", "wait", PLAN),
    "backbone_wait_ms.predict": ("predict", "wait", ("backbone3d",)),
    "head_nms_wait_ms.predict": ("predict", "wait",
                                 ("bev+head", "decode+nms")),
    "launches.predict": ("predict", "launches", ("predict",)),
    "plan_wait_ms.train": ("train", "wait", PLAN),
    "backbone_wait_ms.train": ("train", "wait", ("backbone3d",)),
    "backward_wait_ms.train": ("train", "wait", ("backward", "optimizer")),
    "launches.train": ("train", "launches", ("step",)),
}
UNITS = {"wait": "ms", "launches": "kernels"}


def read(name, rec):
    """Metric `name` of a traced record; None where the record lacks the
    stretch's keys or is another entry's."""
    entry, what, names = METRICS[name]
    if rec.get("entry") != entry:
        return None
    if what == "wait":
        waits = rec.get("span_wait_ms")
        return None if waits is None else sum(waits.get(s, 0.0)
                                              for s in names)
    kernels = rec.get("span_kernels")
    return None if kernels is None else kernels.get(names[0], 0.0)


class _Nest:
    """Properly nested spans (name, start, end), for the innermost one
    holding a time (start <= t < end) and its enclosing names."""

    def __init__(self, spans):
        order = sorted(range(len(spans)),
                       key=lambda i: (spans[i][1], -spans[i][2]))
        self.spans = [spans[i] for i in order]
        self.starts = [s[1] for s in self.spans]
        self.parent, stack = [], []
        for j, (_, s, e) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][2] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(j)

    def innermost(self, t):
        j = bisect.bisect_right(self.starts, t) - 1
        while j is not None and j >= 0:
            if t < self.spans[j][2]:
                return j
            j = self.parent[j]
        return None

    def names(self, j):
        out = set()
        while j is not None:
            out.add(self.spans[j][0])
            j = self.parent[j]
        return out


def attribute(ops, spans):
    """ops: (start_ns, end_ns, launch_ns or None, is_kernel) of the
    device's ops; spans: (name, start_ns, end_ns), properly nested, on the
    same clock.  Returns wait_ns ({span name, "outside" or "unlinked": ns
    of idle gaps charged}), idle_ns, kernels ({span name: kernels launched
    inside a span of that name, at any depth}) and where (each op's
    innermost span name, "outside" or "unlinked")."""
    nest = _Nest(spans)
    where, kernels = [], {}
    for _, _, launch, is_kernel in ops:
        j = None if launch is None else nest.innermost(launch)
        where.append("unlinked" if launch is None else
                     "outside" if j is None else nest.spans[j][0])
        if is_kernel and j is not None:
            for name in nest.names(j):
                kernels[name] = kernels.get(name, 0) + 1
    wait, idle, end = {}, 0, None
    for i in sorted(range(len(ops)), key=lambda i: ops[i][0]):
        s, e = ops[i][0], ops[i][1]
        if end is not None and s > end:
            wait[where[i]] = wait.get(where[i], 0) + (s - end)
            idle += s - end
        end = e if end is None else max(end, e)
    return {"wait_ns": wait, "idle_ns": idle, "kernels": kernels,
            "where": where}


def _kind(e):
    kind = getattr(e, "activity_type", None)
    return kind() if kind is not None else None


def read_events(events):
    """The device's ops as (start, end, correlation id, is_kernel, name)
    and the host's records as {correlation id: start} and (name, start),
    from a capture's raw events (`prof.profiler.kineto_results.events()`).
    The ops are kernels, copies and memsets.  Where torch gives no kind (no
    `activity_type`, as in torch 2.11), a host record is a launch when its
    name is a CUDA API's ("cu..."), and a device event that is no user
    annotation is an op, a kernel unless a Memcpy or Memset."""
    import torch

    ops, launch, host = [], {}, []
    for e in events:
        kind = _kind(e)
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((e.name(), e.start_ns()))
            if kind in HOST_KINDS or (kind is None
                                      and e.name().startswith("cu")):
                launch[e.correlation_id()] = e.start_ns()
        elif kind in DEVICE_KINDS or (kind is None
                                      and not e.is_user_annotation()):
            is_kernel = DEVICE_KINDS[kind] if kind else not e.name(
                ).startswith(("Memcpy", "Memset"))
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id(), is_kernel, e.name()))
    return ops, launch, host


def stretch(run_one, n):
    """Runs run_one(i) for i < n under the device's trace with the
    program's spans recorded; returns the record's keys a batch (or
    step): span_wait_ms, span_idle_ms, span_kernels, span_named (the NAMED
    kernels' innermost spans), span_clock (the spans' fit to the trace's
    clock, in us) and span_s (the stretch's seconds).  {} where the program
    has no span recorder."""
    try:
        from detzero_tpu_torch.core import profiling
        recording, align = profiling.recording, profiling.align
    except (ImportError, AttributeError):
        return {}
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with recording() as rec:
            for i in range(n):
                run_one(i)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    ops, launch, host = read_events(prof.profiler.kineto_results.events())
    clock = align(rec, host)
    got = attribute([(s, e, launch.get(c), k) for s, e, c, k, _ in ops],
                    [(s.name, s.start_ns, s.end_ns) for s in rec])
    named = {}
    for (_, _, _, _, name), where in zip(ops, got["where"]):
        for label, pat in NAMED.items():
            if re.search(pat, name):
                counts = named.setdefault(label, {})
                counts[where] = counts.get(where, 0) + 1
    return {"span_wait_ms": {k: v / 1e6 / n
                             for k, v in got["wait_ns"].items()},
            "span_idle_ms": got["idle_ns"] / 1e6 / n,
            "span_kernels": {k: v / n for k, v in got["kernels"].items()},
            "span_named": named,
            "span_clock": {k.replace("_ns", "_us"): v / 1e3
                           for k, v in clock.items()},
            "span_s": seconds}


def on_cost(run_one, n):
    """The seconds of n items with spans off and on, plain (no profiler,
    no stage events), each the mean of four stretches run off, on, on,
    off, off, on, on, off; run before any profiler, which leaves launches
    slower after it stops.  {} where the program has no span recorder."""
    from detzero_tpu_torch.core import profiling

    if not hasattr(profiling, "recording"):
        return {}
    import torch

    secs = {False: 0.0, True: 0.0}
    for on in (False, True, True, False) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if on:
            with profiling.recording():
                for i in range(n):
                    run_one(i)
                torch.cuda.synchronize()
        else:
            for i in range(n):
                run_one(i)
            torch.cuda.synchronize()
        secs[on] += (time.perf_counter() - t0) / 4
    return {"span_off_s": secs[False], "span_on_s": secs[True]}


def report(rec):
    """One line on standard error: every span's wait a batch, outside,
    the idle time they add up to, the kernels a batch by span, the
    clock's fit and the recording's on-cost."""
    waits = sorted(rec["span_wait_ms"].items(), key=lambda kv: -kv[1])
    kern = {k: v for k, v in rec["span_kernels"].items()
            if k in ("predict", "step")}
    line = ("spans: wait ms a batch " + ", ".join(f"{k} {v:.4f}"
                                                  for k, v in waits)
            + f"; sum {sum(rec['span_wait_ms'].values()):.4f} of idle "
            f"{rec['span_idle_ms']:.4f}; kernels a batch {kern}; named "
            f"{rec['span_named']}; clock us {rec['span_clock']}")
    if "span_on_s" in rec:
        line += (f"; plain off {rec['span_off_s']:.4f} s, on "
                 f"{rec['span_on_s']:.4f} s (x"
                 f"{rec['span_on_s'] / rec['span_off_s']:.4f})")
    print(line, file=sys.stderr)


def with_spans(traced):
    """`traced` (the harness's `tracing.traced`) with the recording's
    on-cost measured before its stretches and the span stretch after
    them, their keys added to its record."""

    def run(run_one, n, hooked, n_host=2):
        cost = on_cost(run_one, n)
        rec = traced(run_one, n, hooked, n_host)
        rec.update(stretch(run_one, n))
        if "span_s" in rec:
            rec.update(cost)
            report(rec)
        return rec

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import benchmark.run as bench_run

    for key, rel in bench_run.CACHES.items():
        os.environ[key] = str(ROOT / rel)
    import torch

    from benchmark import harness, resolve, tracing

    torch.set_num_threads(1)
    cell = resolve.cell(args.workload)
    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 2
    plain = tracing.traced
    tracing.traced = with_spans(plain)
    try:
        result, record = harness.run_cell(cell, args.seed, args.seconds, 1,
                                          "cuda", t_start)
    finally:
        tracing.traced = plain
    line = bench_run.result_line(args.workload, result, record,
                                 torch.cuda.get_device_name(0),
                                 int(cell["chips"]))
    for name, (_, what, _) in METRICS.items():
        value = read(name, record)
        if value is not None:
            line["metrics"][name] = {"value": value, "unit": UNITS[what]}
    line["spans"] = {k: v for k, v in record.items()
                     if k.startswith("span_")}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

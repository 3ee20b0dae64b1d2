"""A per-op time table from a saved trace (port of tools/analyze_trace.py,
which reads jax.profiler's XPlane protos; this one reads the Chrome trace
JSON that torch.profiler writes: `core/profiling.trace`'s
`<logdir>/trace.json` and `Trainer.fit(profile_dir=)`'s).

    python -m detzero_tpu_torch.tools.analyze_trace <logdir-or-trace.json>
        [--top 30] [--plane cuda]

A directory is searched for `*.json` and `*.json.gz` traces.  Each trace
gives planes:

  * `/device:cuda:<i>`: the card's kernel, memcpy and memset events (one
    a launch), so summing durations by name gives the kernels' own time;
  * `/host:CPU`: the CPU ops, the program's spans and stages (the
    regions `core/profiling` opens while its capture runs) and the CUDA
    runtime calls.  These nest (an op inside an op inside a region), so a name's
    total is its inclusive time, as the reference says of its host planes.

Each plane's table lists, by total time: total ms, share of the plane's
summed time, count, mean ms and name.  Reads the JSON with the standard
library alone (no tensorboard, no tensorflow).  `main(argv)` returns the
aggregate {plane: {name: [total_us, count]}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
HOST_PLANE = "/host:CPU"


def trace_files(path):
    path = Path(path)
    if path.is_dir():
        files = sorted(p for p in path.rglob("*")
                       if p.name.endswith((".json", ".json.gz")))
    else:
        files = [path]
    if not files:
        raise FileNotFoundError(f"no .json or .json.gz trace under {path}")
    return files


def load_events(path):
    """The trace events of one Chrome trace (a {"traceEvents": [...]}
    object or a bare list of events)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def plane_of(ev):
    """The plane of a complete ('X') event, or None."""
    if ev.get("ph") != "X":
        return None
    cat = ev.get("cat", "")
    if cat in DEVICE_CATS:
        return f"/device:cuda:{ev.get('args', {}).get('device', 0)}"
    if cat in HOST_CATS:
        return HOST_PLANE
    return None


def aggregate(files, plane_filter=None):
    """-> {plane: {event name: [total_us, count]}}, device planes first."""
    out = {}
    for path in files:
        for ev in load_events(path):
            plane = plane_of(ev)
            if plane is None or (plane_filter and plane_filter.lower()
                                 not in plane.lower()):
                continue
            agg = out.setdefault(plane, defaultdict(lambda: [0.0, 0]))
            agg[ev["name"]][0] += float(ev.get("dur", 0.0))
            agg[ev["name"]][1] += 1
    return dict(sorted(out.items(), key=lambda kv: kv[0] == HOST_PLANE))


def report(agg, top: int) -> str:
    lines = []
    for plane, events in agg.items():
        if not events:
            continue
        total_us = sum(v[0] for v in events.values())
        lines.append(f"\n== {plane}  ({len(events)} distinct events, "
                     f"{total_us / 1e3:.3f} ms summed)")
        lines.append(f"{'time_ms':>10}  {'share':>6}  {'count':>8}  "
                     f"{'mean_ms':>9}  name")
        ranked = sorted(events.items(), key=lambda kv: -kv[1][0])[:top]
        for name, (us, n) in ranked:
            lines.append(f"{us / 1e3:10.3f}  "
                         f"{100 * us / max(total_us, 1e-9):5.1f}%  "
                         f"{n:8d}  {us / 1e3 / n:9.4f}  {name[:100]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser("Chrome trace summary")
    ap.add_argument("path", help="trace directory or a .json/.json.gz file")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--plane", default=None,
                    help="substring filter on the plane name (e.g. cuda, "
                         "host)")
    args = ap.parse_args(argv)
    files = trace_files(args.path)
    print(f"loaded {len(files)} trace file(s)")
    agg = aggregate(files, args.plane)
    print(report(agg, args.top))
    return agg


if __name__ == "__main__":
    main()

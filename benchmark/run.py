"""Runs one cell of the benchmark of `detzero_tpu_torch` once and prints
its result as the last line of standard output:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`--trace 0` measures the cell's end-to-end metrics over a window of
`--seconds`; `--trace 1` runs a short traced window and reports the
per-layer metrics.  Both compare what the window produced with the plain
reference (`benchmark/reference/`) and print each compared number beside
its limit, last on standard error and under "checks" in the result.  The
run needs a CUDA card; it exits 2 without one.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches stay inside the checkout, at fixed paths
CACHES = {"TRITON_CACHE_DIR": "build/triton_cache",
          "TORCHINDUCTOR_CACHE_DIR": "build/inductor_cache"}
# top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "detzero_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def metrics_of(cell_name, result, record):
    from benchmark import resolve

    if record is None:
        produced = result["e2e"]
        return {k: {"value": v, "unit": u}
                for k, (v, u) in resolve.end_to_end_metrics(
                    cell_name, produced).items()}
    out = {}
    for name, unit in resolve.per_layer_metrics(cell_name):
        value = resolve.metric_reader(name).read(record)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def result_line(cell_name, result, record, kind, chips):
    """The last line's object: correct, attempted, failed, metrics, device,
    with --trace 1 the breakdown, and last the compared numbers."""
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"],
            "metrics": metrics_of(cell_name, result, record),
            "device": device}
    if record is not None:
        device.update(busy_s=record["busy_s"], window_s=record["window_s"])
        line["breakdown"] = record["breakdown"]
    line["checks"] = result["checks"]
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness, resolve

    # the host drives the card from one thread; a pool of CPU threads only
    # competes with it
    torch.set_num_threads(1)
    cell = resolve.cell(args.workload)
    chips = int(cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{found}", file=sys.stderr)
        return 2
    drift = resolve.yaml_drift(cell["config_data"])
    if drift:
        print(f"benchmark: configs/{cell['config']}.json and the yaml it "
              f"mirrors differ at {', '.join(drift)}", file=sys.stderr)
        return 4
    result, record = harness.run_cell(cell, args.seed, args.seconds,
                                      args.trace, "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = result_line(args.workload, result, record,
                       torch.cuda.get_device_name(0), chips)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

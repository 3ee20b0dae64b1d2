"""Readings that set a cell's limits, in one process on the card: the
program's numbers on many seeds (a short window each), the control's (the
reference in float8 in the program's place) and, for a training cell, the
program with half of each batch left out.  One JSON line a reading:

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        --control-seeds 4 5 6 [--fault-seeds 7 8 9] [--seconds 2]
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed, device):
    """The control's numbers on the frames a run checks first: the
    entry's own `control` where its module gives one."""
    import torch
    from benchmark import checks, harness, scene, weights
    from benchmark.reference import network, train as ref_train

    run = harness.Run(cell, seed, 0, False, device, time.perf_counter())
    if hasattr(run.entry, "control"):
        return run.entry.control(cell, seed, device)
    if cell["entry"] not in harness.ENTRIES:
        raise ValueError(f"entry {cell['entry']!r} gives no control")
    shapes = harness.state_shapes(harness.build_model(run.config, "meta"))
    pool = scene.make_pool(run.mix, seed, int(run.config["NUM_POINT_BUDGET"]),
                           int(run.config["MAX_OBJS"]), device)
    sd = weights.calibrate(weights.make(shapes, seed, device),
                           pool["points"][:1], pool["points_valid"][:1],
                           run.rcfg)
    b, n = int(run.mix["batch"]), int(run.mix["check_batches"])
    if cell["entry"] == "predict":
        frames = [(pool["points"][f], pool["points_valid"][f], None, None)
                  for f in range(b * n)]
        return checks.predict_numbers(sd, frames, run.rcfg,
                                      prec=network.FP8, device=device)
    keys = ("points", "points_valid", "gt_boxes", "gt_classes", "gt_valid")
    batches = [{k: pool[k][i * b:(i + 1) * b] for k in keys}
               for i in range(n)]
    total = int(run.mix["schedule_steps"])
    opt = run.config["OPTIMIZATION"]
    losses, grads, params, stats = ref_train.train_steps(
        sd, batches, run.rcfg, opt, total, network.FP8)
    program = {"losses": losses,
               "bn_vars": {k: v.double().cpu() for k, (_, v) in
                           stats.items()},
               "grad_norms": {k: float(v.double().norm())
                              for k, v in grads.items()},
               "change_norms": {k: float((params[k].double()
                                          - sd[k].double()).norm())
                                for k in params}}
    torch.cuda.empty_cache()
    nums, ref = checks.train_numbers(program, sd, batches, run.rcfg, opt,
                                     total)
    return dict(nums, worst=ref["worst"])


def half_batch(trainer, batch):
    """A step that leaves out half of the batch (the loss is the mean over
    the rest)."""
    half = batch["points"].shape[0] // 2
    return trainer.step({k: v[:half] for k, v in batch.items()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[],
                    help="the program in float32, a second witness")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness, resolve

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = resolve.cell(args.workload)

    def emit(kind, seed, numbers, **extra):
        print(json.dumps(dict(kind=kind, seed=seed, numbers=numbers,
                              **extra)), flush=True)

    for seed in args.seeds:
        res, _ = harness.run_cell(cell, seed, args.seconds, 0, "cuda")
        emit("program", seed, res["numbers"], failed=res["failed"],
             worst=res["worst"],
             e2e=res["e2e"], peak=res["memory_peak_bytes"])
    for seed in args.control_seeds:
        nums = control_numbers(cell, seed, "cuda")
        emit("control", seed, nums, worst=nums.pop("worst", None))
        torch.cuda.empty_cache()
    for seed in args.witness_seeds:
        f32 = dict(cell, config_data=dict(cell["config_data"],
                                          dtype="float32"))
        res, _ = harness.run_cell(f32, seed, args.seconds, 0, "cuda")
        emit("program_float32", seed, res["numbers"], worst=res["worst"])
    for seed in args.fault_seeds:
        res, _ = harness.run_cell(cell, seed, args.seconds, 0, "cuda",
                                  fault={"step_call": half_batch})
        emit("fault_half_batch", seed, res["numbers"], worst=res["worst"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

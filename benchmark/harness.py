"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the comparison with the reference, the result.

The program under test is `detzero_tpu_torch`: `CenterPoint.predict` in
the predict entry, `Trainer.step` in the train entry.  The benchmark makes
the frames (`scene.py`) and the weights (`weights.py`) from the seed and
hands the same to the program and to the reference.
"""

from __future__ import annotations

import gc
import random
import resource
import sys
import time
from types import SimpleNamespace

import torch

from benchmark import checks, resolve, scene, tracing, weights, work
from benchmark.reference import geometry

TRACED = {"predict": 6, "train": 4}      # batches / steps in a traced run


def reference_cfg(config):
    """The reference's view of a configuration file."""
    m = config["MODEL"]
    grid = geometry.grid_of(config["POINT_CLOUD_RANGE"], config["VOXEL_SIZE"])
    stride = int(m.get("FEATURE_MAP_STRIDE", 8))
    return {
        "grid": grid, "voxel_size": tuple(config["VOXEL_SIZE"]),
        "pc_range": tuple(config["POINT_CLOUD_RANGE"]),
        "capacities": tuple(m["VOXEL_CAPACITIES"]),
        "row_budget": int(m.get("PILLAR_ROW_BUDGET", 128)),
        "bev_layer_nums": tuple(m.get("BEV_LAYER_NUMS", (5, 5))),
        "class_ids_each_head": [tuple(g) for g in m["CLASS_IDS_EACH_HEAD"]],
        "with_velocity": bool(m.get("WITH_VELOCITY", True)),
        "with_iou": bool(m.get("WITH_IOU", True)),
        "feature_map_stride": stride,
        "bev_hw": (-(-grid[1] // stride), -(-grid[2] // stride)),
        "post_processing": m["POST_PROCESSING"],
    }


def build_model(config, device):
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    return CenterPoint(
        config["MODEL"], len(config["CLASS_NAMES"]),
        pc_range=config["POINT_CLOUD_RANGE"],
        voxel_size=config["VOXEL_SIZE"],
        max_voxels=int(config["MODEL"].get("MAX_VOXELS", 150_000)),
        max_points=int(config["NUM_POINT_BUDGET"]),
        max_objs=int(config["MAX_OBJS"]),
        num_point_features=len(config["used_feature_list"]),
        dtype=getattr(torch, config["dtype"]), device=device)


def state_shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _pinned_batches(pool, batch, keys):
    """Host copies, pinned where a card is used, as (n_batches, batch,
    ...): the pool's frames in order."""
    nb = pool["points"].shape[0] // batch
    pin = torch.cuda.is_available()
    out = {}
    for k in keys:
        t = pool[k][:nb * batch].cpu()
        t = t.reshape(nb, batch, *t.shape[1:]).contiguous()
        out[k] = t.pin_memory() if pin else t
    return out, nb


def _to(host, j, device):
    return {k: v[j].to(device, non_blocking=True) for k, v in host.items()}


def _settle():
    """Collects garbage once and moves what set-up left into the permanent
    generation, so the window's collections do not rescan it."""
    gc.collect()
    gc.freeze()


def _cpu_s():
    """(this process's CPU seconds, its main thread's)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, time.thread_time()


def _report_window(what, seconds, before):
    """One line on standard error: the host's CPU time over the window
    (the main thread also spins while it waits on the card)."""
    cpu, thread = (b - a for a, b in zip(before, _cpu_s()))
    print(f"window: {what} in {seconds:.3f} s; this process's CPU "
          f"{cpu:.3f} s, its main thread {thread:.3f} s", file=sys.stderr)


def _report_trace(rec):
    """One line on standard error: the traced stretches' seconds and the
    device trace's cost as the ratio of its window to the plain one."""
    print(f"traced: plain {rec['plain_s']:.4f} s, device-traced "
          f"{rec['window_s']:.4f} s (x{rec['window_s'] / rec['plain_s']:.4f})"
          f", busy {rec['busy_s']:.4f} s", file=sys.stderr)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """The state one run carries from set-up to the result."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 fault=None):
        self.cell, self.seed, self.seconds = cell, int(seed), seconds
        self.trace, self.device, self.t_start = bool(trace), device, t_start
        self.fault = fault or {}
        self.config = cell["config_data"]
        self.mix = cell["mix_data"]
        self.rcfg = reference_cfg(self.config)
        self.entry = (ENTRIES.get(cell["entry"])
                      or resolve.entry(cell["entry"], cell["base"]))
        self.record = {"entry": self.entry.KIND}

    # ------------------------------------------------------------------
    def setup(self, calibrate=weights.calibrate):
        """Builds the model and the frames, and loads the seeded weights;
        `calibrate(sd, points, valid, rcfg)` sets the batch norms'
        statistics (an entry whose model has batch norms the default does
        not know passes its own)."""
        torch.manual_seed(self.seed % (2 ** 63))
        self.model = build_model(self.config, self.device)
        self.shapes = state_shapes(self.model)
        self.pool = scene.make_pool(self.mix, self.seed,
                                    int(self.config["NUM_POINT_BUDGET"]),
                                    int(self.config["MAX_OBJS"]),
                                    self.device)
        sd = calibrate(
            weights.make(self.shapes, self.seed, self.device),
            self.pool["points"][:1], self.pool["points_valid"][:1], self.rcfg)
        self.model.load_state_dict(sd)
        # the reference gets the same tensors after the window
        self.weights = {k: v.cpu() for k, v in sd.items()}
        del sd

    def reference_weights(self):
        return {k: v.to(self.device) for k, v in self.weights.items()}

    def free_program(self):
        """Drops the program's state before the reference runs."""
        if hasattr(self, "model"):
            del self.model
        gc.unfreeze()
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def memory_peak(self):
        if torch.device(self.device).type == "cuda":
            return int(torch.cuda.max_memory_allocated())
        return 0

    def work_of(self, frame_ids):
        """Work counts of pool frames, from the reference's sites."""
        out = {}
        stem_cin = len(self.config["used_feature_list"])
        for f in sorted(set(frame_ids)):
            levels, fz, _ = geometry.build_levels(
                self.pool["points"][f].to(self.device),
                self.pool["points_valid"][f].to(self.device), self.rcfg)
            out[f] = work.frame_work(levels, fz, self.rcfg, stem_cin)
            out[f]["pillars"] = [int(lv.cells.shape[0]) for lv in levels]
            out[f]["sites"] = [lv.n_sites for lv in levels]
        n = len(out)
        print("sites a frame, mean over the traced frames: pillars "
              + " ".join(str(sum(w["pillars"][i] for w in out.values()) // n)
                         for i in range(4))
              + "; conv sites "
              + " ".join(str(sum(w["sites"][i] for w in out.values()) // n)
                         for i in range(4)), file=sys.stderr)
        return out


# ----------------------------------------------------------------------
def run_predict(run):
    """Closed loop: each batch is copied from pinned host memory, predicted
    and its boxes copied back to the host, the next sent when it is done."""
    run.setup()
    b = int(run.mix["batch"])
    host, nb = _pinned_batches(run.pool, b, ("points", "points_valid"))
    model, dev = run.model, run.device
    captured, capture = [], [False]
    model.center_head.register_forward_hook(
        lambda mod, inp, out: captured.append(out) if capture[0] else None)
    pp = run.config["MODEL"]["POST_PROCESSING"]
    # the decode arguments tools/test_det.py passes from POST_PROCESSING
    kw = dict(top_k=int(pp["TOP_K"]), score_thresh=float(pp["SCORE_THRESH"]),
              nms_thresh=float(pp["NMS_THRESH"]),
              nms_pre=int(pp["NMS_PRE_MAXSIZE"]),
              nms_post=int(pp["NMS_POST_MAXSIZE"]))
    predict = run.fault.get("predict_call",
                            lambda m, p, v, **k: m.predict(p, v, **k))

    def batch(i):
        x = _to(host, i % nb, dev)
        out = predict(model, x["points"], x["points_valid"], **kw)
        return {k: v.cpu() for k, v in out.items()}

    for i in range(nb):          # warm-up: every distinct batch once
        batch(i)
    _sync(dev)
    rng = random.Random(run.seed)
    n_check = int(run.mix["check_batches"])
    n_first = TRACED["predict"] if run.trace else nb
    check = set(rng.sample(range(n_first), min(n_check, n_first)))
    saved, missing = {}, [0]

    def one(i):
        capture[0] = i in check
        del captured[:]
        out = batch(i)
        if capture[0]:
            if len(captured) != b:
                missing[0] += b - len(captured)
            # one center-head call a frame, a dict a head
            saved[i] = (out, [[{k: v[0] for k, v in h.items()} for h in c]
                              for c in captured])
        return out

    _settle()
    setup_s = time.perf_counter() - run.t_start
    if run.trace:
        rec = tracing.traced(one, TRACED["predict"], [model])
        n = TRACED["predict"]
        frames = [(i % nb) * b + j for i in range(n) for j in range(b)]
        works = run.work_of(frames)
        rec["bound_s"] = {"K2": sum(work.k2_bound([works[f]])
                                    for f in frames)}
        rec["flops"] = sum(work.flops(works[f], False) for f in frames)
        rec.update(batches=n, frames=n * b)
        run.record.update(rec)
        _report_trace(rec)
        attempted = n
    else:
        i = 0
        before = _cpu_s()
        t0 = time.perf_counter()
        while True:
            one(i)
            i += 1
            e = time.perf_counter()
            if e - t0 >= run.seconds and i > max(check):
                break
        _report_window(f"{i} batches", e - t0, before)
        run.e2e = {"frames_per_s": (i * b / (e - t0), "frames/s")}
        attempted = i
    run.e2e_setup = setup_s
    peak = run.memory_peak()
    del model, batch, one
    run.free_program()
    sd = run.reference_weights()
    frames = []
    for i in sorted(saved):
        out, maps_list = saved[i]
        for j, maps in enumerate(maps_list):
            f = (i % nb) * b + j
            frames.append((run.pool["points"][f], run.pool["points_valid"][f],
                           maps, {k: v[j] for k, v in out.items()}))
    numbers = checks.predict_numbers(sd, frames, run.rcfg, device=dev)
    return attempted, missing[0], numbers, peak


def clipped_norms(norms, names, clip):
    """{leaf: norm} of the gradient the optimizer gets: `norms` ({leaf:
    norm tensor} of the raw gradients; a leaf with none has 0) scaled by
    the global-norm clip (by clip / norm where the global norm reaches
    `clip`)."""
    total = float(torch.stack(list(norms.values())).square().sum().sqrt()
                  ) if norms else 0.0
    scale = clip / total if clip > 0 and total >= clip else 1.0
    return {n: float(norms[n]) * scale if n in norms else 0.0
            for n in names}


def run_train(run):
    """The trainer steps on batches copied from pinned host memory; the
    first three (set-up) are the ones the reference follows."""
    from detzero_tpu_torch.core.optim import build_optimizer
    from detzero_tpu_torch.parallel.trainer import Trainer

    run.setup()
    b = int(run.mix["batch"])
    keys = ("points", "points_valid", "gt_boxes", "gt_classes", "gt_valid")
    host, nb = _pinned_batches(run.pool, b, keys)
    model, dev = run.model, run.device
    total = int(run.mix["schedule_steps"])
    trainer = Trainer(model, build_optimizer(run.config["OPTIMIZATION"],
                                             total, model), seed=run.seed)
    step = run.fault.get("step_call", lambda t, batch: t.step(batch))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_check = int(run.mix["check_batches"])
    losses, grad_norms = [], {}
    # the first step's gradient of each leaf as backward leaves it, by a
    # hook on the leaf: nothing read from the optimizer's own state
    first = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: first.__setitem__(n, p.grad.detach().double().norm()))
        for n, p in model.named_parameters() if p.requires_grad]
    bn0 = {k: v.detach().double().cpu() for k, v in model.state_dict().items()
           if k.endswith(".var")}
    bn_vars = {}
    for i in range(n_check):
        loss, _, _ = step(trainer, _to(host, i % nb, dev))
        losses.append(float(loss))
        if i == 0:
            for h in hooks:
                h.remove()
            grad_norms = clipped_norms(
                first, [n for n, _ in model.named_parameters()],
                float(run.config["OPTIMIZATION"].get("GRAD_NORM_CLIP", 0)))
            # the step's batch variances from the running ones (decay 0.99)
            sd1 = model.state_dict()
            bn_vars = {k[:-4]: (sd1[k].double().cpu() - 0.99 * v) / 0.01
                       for k, v in bn0.items()}
    change = {n: float((p.detach().double() - init[n].double()).norm())
              for n, p in model.named_parameters()}
    del init
    program = {"losses": losses, "grad_norms": grad_norms,
               "change_norms": change, "bn_vars": bn_vars}
    _settle()
    setup_s = time.perf_counter() - run.t_start
    if run.trace:
        rec = tracing.traced(
            lambda i: step(trainer, _to(host, (n_check + i) % nb, dev)),
            TRACED["train"], [model, trainer])
        n = TRACED["train"]
        steps = [[((n_check + i) % nb) * b + j for j in range(b)]
                 for i in range(n)]
        works = run.work_of([f for s in steps for f in s])
        rec["bound_s"] = {
            "K4": sum(work.k4_bound([works[f] for f in s]) for s in steps),
            "K5": sum(work.k5_bound([works[f] for f in s]) for s in steps)}
        rec["flops"] = sum(work.flops(works[f], True)
                           for s in steps for f in s)
        rec.update(batches=n, frames=n * b)
        run.record.update(rec)
        _report_trace(rec)
        attempted, failed = n, 0
    else:
        i, out = 0, []
        before = _cpu_s()
        t0 = time.perf_counter()
        while True:
            loss, _, _ = step(trainer, _to(host, (n_check + i) % nb, dev))
            out.append(loss)
            i += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        _sync(dev)
        window = time.perf_counter() - t0
        _report_window(f"{i} steps", window, before)
        failed = int((~torch.isfinite(torch.stack(out))).sum())
        run.e2e = {"train_step_ms": (window * 1e3 / i, "ms/step")}
        attempted = i
    run.e2e_setup = setup_s
    peak = run.memory_peak()
    batches = [{k: host[k][i % nb].to(dev) for k in keys}
               for i in range(n_check)]
    del model, trainer
    run.free_program()
    sd = run.reference_weights()
    numbers, ref = checks.train_numbers(
        program, sd, batches, run.rcfg, run.config["OPTIMIZATION"], total)
    run.worst = ref["worst"]
    return attempted, failed, numbers, peak


# the built-in entries; a cell's other entry is a file (`resolve.entry`)
ENTRIES = {kind: SimpleNamespace(KIND=kind, run=run)
           for kind, run in (("predict", run_predict), ("train", run_train))}


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None,
             fault=None):
    """Runs the cell once.  Returns (result dict without the device's
    name, the record of the traced window or None)."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed, seconds, trace, device, t_start, fault)
    attempted, failed, numbers, peak = run.entry.run(run)
    limits = cell["limits"]
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "memory_peak_bytes": peak,
              "numbers": numbers, "worst": getattr(run, "worst", None),
              "checks": {k: {"value": numbers[k], "limit": limits[k]}
                         for k in limits}}
    if trace:
        return result, run.record
    result["e2e"] = dict(run.e2e, setup_s=(run.e2e_setup, "s"))
    return result, None

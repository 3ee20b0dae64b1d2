"""The two-stage cell's entry (`entries/pdv_predict.py`) on a tiny
two-stage cell on the CPU: an untraced and a traced run (the device's
trace and the span stretch stood in for by host clocks) to a `correct`
line with the new metrics; the faults that must fail (an altered answer,
the attention left out, the proposals shuffled); the control against the
cell's limits; the RoI head's work counts against the reference's; the
five new readers on other records; and a reference that loads nothing of
the program."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import (calibrate, harness, resolve, scene, tracing,
                       weights, work_pdv)
from benchmark.reference import pdv
import benchmark.run as bench_run

HERE = Path(__file__).resolve().parent
TINY = HERE / "tiny"
SEED = 3_000_000_037
NEW = ("proposals_ms.predict", "roi_head_ms.predict",
       "roi_head_wait_ms.predict", "roi_head_launches.predict",
       "roi_head_roofline")
LIMITS = {"head_gap": 0.001, "proposal_miss": 0.05, "roi_gap": 0.001,
          "refined_miss": 0.05}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A benchmark directory holding the tiny two-stage cell `tiny.pdv`
    with the new entry, and every reader; one CPU thread while the module
    runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("pdv") / "benchmark"
    shutil.copytree(TINY, out)
    shutil.copy(HERE.parent / "entries" / "pdv_predict.py",
                out / "entries")
    shutil.copytree(HERE.parent / "metrics", out / "metrics")
    config = json.loads((TINY / "configs" / "tiny.json").read_text())
    config["MODEL"].update(SECOND_STAGE=True, ROI_BUDGET=16,
                           ROI_GRID_SIZE=3, ROI_ATTENTION=True)
    (out / "configs" / "tiny_pdv.json").write_text(json.dumps(config))
    cell = json.loads((TINY / "cells" / "tiny.predict.json").read_text())
    cell.update(config="tiny_pdv", entry="pdv_predict", why="tiny PDV",
                limits=LIMITS)
    (out / "cells" / "tiny.pdv.json").write_text(json.dumps(cell))
    yield out
    torch.set_num_threads(threads)


def run(base, trace=0, fault=None):
    return harness.run_cell(resolve.cell("tiny.pdv", base=base), SEED, 0.2,
                            trace, device="cpu", fault=fault)


def test_untraced_run_is_correct(base):
    res, _ = run(base)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(LIMITS)
    assert res["numbers"]["rois_checked"] >= 16
    line = bench_run.result_line("tiny.pdv", res, None, "cpu", 1)
    assert {"frames_per_s", "setup_s"} <= set(line["metrics"])


class HostStages:
    """A stage hook on the host's clock, in place of the CUDA events."""

    def __init__(self):
        self.marks = []

    def __call__(self, name):
        self.marks.append((name, time.perf_counter()))

    def ms(self):
        out = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if name != "end":
                out[name] = out.get(name, 0.0) + 1e3 * (b - a)
        return out


def host_traced(run_one, n, hooked, n_host=2):
    """`tracing.traced`'s record from host clocks: the card busy half the
    stretch, K2 a tenth."""
    ev = HostStages()
    for obj in hooked:
        obj.stage_hook = ev
    t0 = time.perf_counter()
    for i in range(n):
        run_one(i)
        ev("end")
    plain = time.perf_counter() - t0
    for obj in hooked:
        obj.stage_hook = None
    return {"plain_s": plain, "stage_ms": ev.ms(), "window_s": plain,
            "busy_s": plain / 2, "kernel_s": {"K2": plain / 10},
            "breakdown": {"device_ops": [], "idle_gaps": []}}


def host_stretch(run_one, n):
    """The span stretch's keys from the recorded spans: every span a
    waited 0.1 ms and launched one kernel, its time on the card its host
    time."""
    from detzero_tpu_torch.core import profiling

    with profiling.recording() as rec:
        for i in range(n):
            run_one(i)
    names = {s.name for s in rec}
    dev = {}
    for s in rec:
        dev[s.name] = dev.get(s.name, 0.0) + s.duration_ns / 1e6 / n
    return {"span_wait_ms": {k: 0.1 for k in names}, "span_idle_ms": 1.0,
            "span_kernels": {k: 1.0 for k in names},
            "span_device_ms": dev}


def test_traced_run_reports_the_new_metrics(base, monkeypatch):
    entry = resolve.entry("pdv_predict", base)
    monkeypatch.setattr(entry, "stretch", host_stretch)
    monkeypatch.setattr(resolve, "entry", lambda name, base: entry)
    monkeypatch.setattr(tracing, "traced", host_traced)
    res, rec = run(base, trace=1)
    assert res["correct"], res["checks"]
    assert rec["entry"] == "predict" and rec["batches"] == 6
    assert rec["bound_s"]["roi_head"] > 0
    line = bench_run.result_line("tiny.pdv", res, rec, "cpu", 1)
    got = line["metrics"]
    for name in NEW + ("mfu.predict", "idle_share.predict", "K2_roofline"):
        assert got[name]["value"] is not None and got[name]["value"] > 0
    assert got["roi_head_wait_ms.predict"]["value"] == pytest.approx(0.6)
    assert got["roi_head_launches.predict"]["value"] == 1.0
    assert got["roi_head_roofline"]["unit"] == "%"
    json.dumps(line)


def _alter_refined(model, pts, valid):
    out = model.predict(pts, valid)
    out["boxes"][0, :, 0] += 0.5
    return out


def _no_attention(model, pts, valid):
    model.roi_head.with_attention = False
    return model.predict(pts, valid)


def _shuffled(model, pts, valid):
    """The RoIs reach the head rolled by one slot: each RoI is pooled
    with another's keypoints, scored with another's proposal score."""
    hook = model.roi_head.register_forward_pre_hook(
        lambda mod, args: (torch.roll(args[0], 1, 1),) + tuple(args[1:]))
    try:
        return model.predict(pts, valid)
    finally:
        hook.remove()


@pytest.mark.parametrize("fault", [_alter_refined, _no_attention, _shuffled],
                         ids=["answer_altered", "attention_left_out",
                              "proposals_shuffled"])
def test_fault_is_not_correct(base, fault):
    res, _ = run(base, fault={"predict_call": fault})
    assert not res["correct"], res["checks"]


def test_control_fails_the_cell_limits(base):
    """The reference in float8 in the program's place fails the cell's
    own RoI limits at this size too."""
    nums = calibrate.control_numbers(resolve.cell("tiny.pdv", base=base),
                                     SEED, "cpu")
    limits = resolve.cell("pdv5.predict.lidar5")["limits"]
    assert nums["roi_gap"] > limits["roi_gap"], nums
    assert nums["refined_miss"] > limits["refined_miss"], nums


def test_work_counts_the_reference_neighbours(base):
    """work_pdv's found neighbours are the reference forward's counts on
    the same RoIs."""
    cell = resolve.cell("tiny.pdv", base=base)
    r = harness.Run(cell, SEED, 0, False, "cpu", 0.0)
    rcfg = r.entry.roi_cfg(r.config, r.rcfg)
    pool = scene.make_pool(r.mix, SEED, r.config["NUM_POINT_BUDGET"],
                           r.config["MAX_OBJS"], "cpu")
    shapes = harness.state_shapes(harness.build_model(r.config, "meta"))
    sd = weights.make(shapes, SEED, "cpu")
    pts, valid = pool["points"][:1], pool["points_valid"][:1]
    _, out = pdv.forward(sd, pts, valid, rcfg)
    mask = out["roi_mask"][0]
    got = work_pdv.frame_work(pts[0], valid[0], out["rois"][0], mask, rcfg,
                              shapes)
    g3 = rcfg["roi_grid_size"] ** 3
    want = [int(c[0].reshape(-1, g3)[mask].sum()) for c in out["counts"]]
    assert got["found"] == want and min(want) > 0
    assert got["rois"] == int(mask.sum())
    assert got["ops"] > 0 and got["bytes"] > 0 and got["pixels"] > 0


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_elsewhere(name):
    reader = resolve.metric_reader(name)
    one_stage = {"entry": "predict", "batches": 6, "plain_s": 1.0,
                 "stage_ms": {"table": 1.0, "bev+head": 2.0,
                              "decode+nms": 3.0},
                 "span_wait_ms": {"plan": 1.0, "decode+nms": 2.0},
                 "span_kernels": {"predict": 900.0},
                 "bound_s": {"K2": 0.01}, "kernel_s": {"K2": 1.0}}
    train = dict(one_stage, entry="train",
                 stage_ms={"RoI head": 1.0, "proposals": 1.0},
                 span_kernels={"RoI head": 1.0},
                 span_device_ms={"RoI head": 1.0},
                 bound_s={"roi_head": 1.0})
    for rec in ({"entry": "none"}, {"entry": "predict"}, one_stage, train):
        assert reader.read(rec) is None


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import benchmark.reference.pdv, benchmark.work_pdv; "
            "print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))"
            ).format(root=str(HERE.parents[1]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    assert not set(out.stdout.split()) & {"detzero_tpu_torch", "detzero_tpu",
                                          "jax", "jaxlib", "flax"}

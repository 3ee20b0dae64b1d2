"""Whole runs of tiny cells on the CPU (the harness without its look for a
card): the last line's keys, a cell added as files alone, the timed path
broken underneath (each fault turns `correct` false), the control, and the
modules a run loads."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import checks, harness, resolve, scene, weights
from benchmark.reference import network
import benchmark.run as bench_run

HERE = Path(__file__).resolve().parent
TINY = HERE / "tiny"
ROOT = HERE.parents[1]
SEED = 3_000_000_029
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(name, fault=None, base=TINY, seconds=0.5):
    return harness.run_cell(resolve.cell(name, base=base), SEED, seconds, 0,
                            device="cpu", fault=fault)[0]


@pytest.mark.parametrize("name", ["tiny.predict", "tiny.train"])
def test_sound_run_is_correct_and_line_has_the_keys(name):
    res = run(name)
    assert res["correct"], res["checks"]
    line = bench_run.result_line(name, res, None, "cpu", 1)
    assert set(line) == LINE_KEYS and list(line)[-1] == "checks"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_keys():
    rec = {"busy_s": 0.5, "window_s": 1.0, "plain_s": 0.8,
           "entry": "predict", "batches": 1,
           "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": []},
           "stage_ms": {"table": 1.0}}
    res = {"correct": True, "attempted": 1, "failed": 0,
           "memory_peak_bytes": 1, "checks": {}}
    line = bench_run.result_line("cp5.predict.lidar5", res, rec, "gpu", 1)
    assert set(line) == LINE_KEYS | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "plan_ms.predict" in line["metrics"]
    assert "K2_roofline" not in line["metrics"]     # nothing to read
    # the idle share divides by the unprofiled stretch, not the trace's
    assert line["metrics"]["idle_share.predict"]["value"] == pytest.approx(
        100 * (1 - 0.5 / 0.8))


def test_new_cell_as_files_alone(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(TINY, base, ignore=shutil.ignore_patterns("entries"))
    shutil.copytree(HERE.parent / "metrics", base / "metrics")
    mix = json.loads((TINY / "traffic" / "tiny_b2.json").read_text())
    mix.update(batch=1, pool_frames=2)
    (base / "traffic" / "tiny_b1.json").write_text(json.dumps(mix))
    cell = json.loads((TINY / "cells" / "tiny.predict.json").read_text())
    cell.update(traffic="tiny_b1", why="batch 1")
    (base / "cells" / "tiny.predict.b1.json").write_text(json.dumps(cell))
    res = run("tiny.predict.b1", base=base)
    assert res["correct"] and res["attempted"] >= 1
    names = [n for n, _ in resolve.per_layer_metrics("tiny.predict.b1",
                                                     base=base)]
    assert "mfu.predict" in names
    # a cell that brings its own entry: a two-stage model (the RoI sizes of
    # the tiny two-stage check on the card)
    config = json.loads((TINY / "configs" / "tiny.json").read_text())
    config["MODEL"].update(SECOND_STAGE=True, ROI_BUDGET=16,
                           ROI_GRID_SIZE=3, ROI_ATTENTION=True)
    (base / "configs" / "tiny_two_stage.json").write_text(json.dumps(config))
    (base / "entries").mkdir()
    shutil.copy(TINY / "entries" / "two_stage_probe.py", base / "entries")
    cell.update(config="tiny_two_stage", entry="two_stage_probe",
                why="two-stage probe", limits={"head_gap": 0.001})
    (base / "cells" / "tiny.two_stage.json").write_text(json.dumps(cell))
    res = run("tiny.two_stage", base=base)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["checks"]) == {"head_gap"}
    line = bench_run.result_line("tiny.two_stage", res, None, "cpu", 1)
    assert line["correct"] and "frames_per_s" in line["metrics"]


def test_control_comes_from_the_entry(tmp_path):
    """`calibrate.control_numbers` takes an entry file's own `control`, and
    refuses an entry file that gives none."""
    from benchmark import calibrate

    base = tmp_path / "benchmark"
    shutil.copytree(TINY, base)
    probe = (TINY / "entries" / "two_stage_probe.py").read_text()
    (base / "entries" / "with_control.py").write_text(
        probe + "\n\ndef control(cell, seed, device):\n"
        "    return {'head_gap': float(seed)}\n")
    cell = json.loads((TINY / "cells" / "tiny.predict.json").read_text())
    for entry in ("with_control", "two_stage_probe"):
        (base / "cells" / f"tiny.{entry}.json").write_text(
            json.dumps(dict(cell, entry=entry)))
    got = calibrate.control_numbers(
        resolve.cell("tiny.with_control", base=base), 7, "cpu")
    assert got == {"head_gap": 7.0}
    with pytest.raises(ValueError, match="gives no control"):
        calibrate.control_numbers(
            resolve.cell("tiny.two_stage_probe", base=base), 7, "cpu")


def _alter_box(model, pts, valid, **kw):
    out = model.predict(pts, valid, **kw)
    assert bool(out["mask"][0].any())
    out["boxes"][0, :, 0] += 0.5          # the first frame's boxes move
    return out


def _half_batch_predict(model, pts, valid, **kw):
    half = pts.shape[0] // 2
    out = model.predict(pts[:half], valid[:half], **kw)
    return {k: torch.cat([v, v]) for k, v in out.items()}


def _half_batch_step(trainer, batch):
    return trainer.step({k: v[:1] for k, v in batch.items()})


def _unchanged_step(trainer, batch):
    before = [p.detach().clone() for p in trainer.model.parameters()]
    out = trainer.step(batch)
    with torch.no_grad():
        for p, b in zip(trainer.model.parameters(), before):
            p.copy_(b)
    return out


@pytest.mark.parametrize("name,fault", [
    ("tiny.predict", {"predict_call": _alter_box}),
    ("tiny.predict", {"predict_call": _half_batch_predict}),
    ("tiny.train", {"step_call": _half_batch_step}),
    ("tiny.train", {"step_call": _unchanged_step}),
], ids=["answer_altered", "half_batch", "train_half_batch",
        "state_unchanged"])
def test_fault_is_not_correct(name, fault):
    assert not run(name, fault=fault)["correct"]


def _control(entry):
    cell = resolve.cell(f"tiny.{entry}", base=TINY)
    run_ = harness.Run(cell, SEED, 0, False, "cpu", 0.0)
    shapes = harness.state_shapes(harness.build_model(run_.config, "meta"))
    pool = scene.make_pool(run_.mix, SEED, run_.config["NUM_POINT_BUDGET"],
                           run_.config["MAX_OBJS"], "cpu")
    sd = weights.calibrate(weights.make(shapes, SEED, "cpu"),
                           pool["points"][:1], pool["points_valid"][:1],
                           run_.rcfg)
    return run_, sd, pool


def test_control_fails_the_predict_limit():
    """The reference in float8 in the program's place fails the flagship
    cell's limit at this size too."""
    run_, sd, pool = _control("predict")
    frames = [(pool["points"][f], pool["points_valid"][f], None, None)
              for f in range(2)]
    nums = checks.predict_numbers(sd, frames, run_.rcfg, prec=network.FP8,
                                  device="cpu")
    limits = resolve.cell("cp5.predict.lidar5")["limits"]
    assert any(nums[k] > v for k, v in limits.items()), nums


def test_control_fails_the_train_limit():
    from benchmark.reference import train as ref_train

    run_, sd, pool = _control("train")
    keys = ("points", "points_valid", "gt_boxes", "gt_classes", "gt_valid")
    b = run_.mix["batch"]
    batches = [{k: pool[k][b * i:b * (i + 1)] for k in keys}
               for i in range(run_.mix["check_batches"])]
    opt = run_.config["OPTIMIZATION"]
    total = run_.mix["schedule_steps"]
    losses, grads, params, stats = ref_train.train_steps(
        sd, batches, run_.rcfg, opt, total, network.FP8)
    program = {"losses": losses,
               "bn_vars": {k: v.double() for k, (_, v) in stats.items()},
               "grad_norms": {k: float(v.norm()) for k, v in grads.items()},
               "change_norms": {k: float((params[k] - sd[k]).norm())
                                for k in params}}
    nums = checks.train_numbers(program, sd, batches, run_.rcfg, opt,
                                total)[0]
    limits = resolve.cell("cp5.train.lidar5")["limits"]
    assert any(nums[k] > v for k, v in limits.items()), nums


IMPORTS = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(tops))
"""


def _loaded(body):
    out = subprocess.run([sys.executable, "-c", IMPORTS.format(
        root=str(ROOT), body=body)], capture_output=True, text=True,
        check=True, timeout=600)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    tops = _loaded(
        "from pathlib import Path\n"
        "import benchmark.run as r\n"
        "from benchmark import harness, resolve\n"
        f"c = resolve.cell('tiny.predict', base=Path({str(TINY)!r}))\n"
        "harness.run_cell(c, 5, 0.1, 0, device='cpu')\n"
        "assert not r.forbidden_modules()\n")
    assert "detzero_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "detzero_tpu"}


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import benchmark.reference.network, "
                   "benchmark.reference.train, benchmark.reference.boxes, "
                   "benchmark.reference.geometry")
    assert not tops & {"detzero_tpu_torch", "detzero_tpu", "jax", "jaxlib",
                       "flax"}


@pytest.mark.cuda
def test_flagship_cell_on_the_card():
    """A short run of the first cell through the command (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "cp5.predict.lidar5", "--seed", "7", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

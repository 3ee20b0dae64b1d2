"""The port's span recorder (`detzero_tpu_torch.core.profiling`): off by
default, where a stage mark reads no clock and allocates nothing; parents,
call identifiers and self times on a hand-made nest; the span tree of a
tiny `CenterPoint.predict` and `Trainer.step`; spans as regions of
`profiling.trace`'s Chrome trace; `StageTimer` stages as spans; and the
spans moved onto a CPU trace's clock, where each op lands in its stage."""

import json
import tracemalloc

import numpy as np
import pytest
import torch

from detzero_tpu_torch.core import profiling

CFG = {"CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
       "VOXEL_CAPACITIES": (256, 128, 64, 32), "BEV_LAYER_NUMS": (1, 1)}
PREPARE = ["prepare", "  table", "  plan", "  row-pad maps", "  vfe"]


@pytest.fixture(scope="module")
def tiny():
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    m = CenterPoint(CFG, 3, pc_range=(-3.2, -3.2, -2.0, 3.2, 3.2, 2.0),
                    voxel_size=(0.2, 0.2, 0.5), dtype=torch.float32,
                    device="cpu")
    m.init_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.uniform(-3, 3, (2, 512, 5)).astype(
        np.float32))
    return m, pts, torch.ones(2, 512, dtype=torch.bool)


def tree(rec):
    """Each span's name, indented two spaces a level."""
    depth = []
    for s in rec:
        depth.append(0 if s.parent is None else depth[s.parent] + 1)
    return ["  " * d + s.name for s, d in zip(rec, depth)]


class Ticks:
    """A clock that steps by 10 ns a read."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 10
        return self.t


def no_clock():
    raise AssertionError("the clock was read")


def test_off_by_default_reads_no_clock(tiny, monkeypatch):
    model, pts, valid = tiny
    assert profiling.ACTIVE is None
    monkeypatch.setattr(profiling, "_clock", no_clock)
    model._stage("table")
    with profiling.span("predict") as s:
        assert s is None
    assert profiling.span("step", "step_count", 3) is profiling.span("x")
    out = model.predict(pts[:1], valid[:1], score_thresh=0.0)
    assert out["boxes"].shape[0] == 1
    with pytest.raises(AssertionError, match="clock"):
        with profiling.recording():
            model._stage("table")


def _peak_delta(fn, n=2000):
    """Bytes allocated at the peak of n calls of fn, over what was
    allocated before them."""
    calls = [None] * n
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        for _ in calls:
            fn("table")
        return tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()


def test_off_stage_mark_allocates_nothing(tiny):
    from detzero_tpu_torch.parallel.trainer import Trainer

    model, _, _ = tiny

    def noop(name):
        pass

    base = _peak_delta(noop)
    assert _peak_delta(model._stage) == base
    assert _peak_delta(Trainer._stage.__get__(
        type("T", (), {"stage_hook": None})())) == base
    # the recorder does allocate when on, so the measure can see it
    with profiling.recording():
        assert _peak_delta(model._stage) > base


def test_hand_made_nest(monkeypatch):
    monkeypatch.setattr(profiling, "_clock", Ticks())
    with profiling.recording() as rec:
        with profiling.span("a", "index", 7):                # 10
            rec.mark("s1")                                  # 20
            rec.mark("s2")                                  # 30
            with profiling.span("b"):                       # 40
                rec.mark("t")                               # 50
            # b ends at 60 and ends t with it; s2 runs on
            rec.mark("s3")                                  # 70
        # a ends at 80, s3 with it
        with profiling.span("c"):                           # 90
            pass                                            # ends 100
        rec.mark("loose")                                   # 110
    assert profiling.ACTIVE is None                         # loose ends 120
    assert tree(rec) == ["a", "  s1", "  s2", "    b", "      t", "  s3",
                         "c", "loose"]
    assert [s.parent for s in rec] == [None, 0, 0, 2, 3, 0, None, None]
    assert [s.call for s in rec] == [0, 0, 0, 0, 0, 0, 6, 7]
    assert [(s.start_ns, s.end_ns) for s in rec] == [
        (10, 80), (20, 30), (30, 70), (40, 60), (50, 60), (70, 80),
        (90, 100), (110, 120)]
    assert rec.self_ns() == [10, 10, 20, 10, 10, 10, 10, 10]
    assert sum(rec.self_ns()[:6]) == rec[0].duration_ns
    assert [s.stage for s in rec] == [False, True, True, False, True, True,
                                      False, True]
    assert rec[0].args == {"index": 7} and rec[0].label == "a index=7"
    assert rec.innermost(45).name == "b" and rec.innermost(55).name == "t"
    assert rec.innermost(65).name == "s2" and rec.innermost(85) is None


def test_stage_timer_stages_are_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_clock", Ticks())
    timer = profiling.StageTimer()
    with timer("alone"):                                    # own recording
        pass
    with profiling.recording() as rec:
        with profiling.span("run"):
            with timer("track"):
                rec.mark("inner")
            timer.block("wait", torch.ones(2))
    assert tree(rec) == ["run", "  track", "    inner", "  wait"]
    assert timer.as_dict() == {
        "alone": {"total_s": 1e-8, "calls": 1},
        "track": {"total_s": rec[1].duration_ns / 1e9, "calls": 1},
        "wait": {"total_s": rec[3].duration_ns / 1e9, "calls": 1}}


def test_predict_span_tree(tiny):
    model, pts, valid = tiny
    names = []
    model.stage_hook = names.append
    try:
        with profiling.recording() as rec:
            model.predict(pts, valid, score_thresh=0.0)
    finally:
        model.stage_hook = None
    one = ["  sample"] + ["    " + n for n in PREPARE] + [
        "    stack", "    backbone3d", "    bev+head", "    decode+nms"]
    assert tree(rec) == ["predict"] + one + one
    assert [s.args for s in rec if s.name in ("sample", "prepare")] == [
        {"index": 0}, {"index": 0}, {"index": 1}, {"index": 0}]
    assert {s.call for s in rec} == {0}
    # the stages are the marks stage_hook gets, in its order
    assert [s.name for s in rec if s.stage] == names
    for s in rec:
        if s.parent is not None:
            p = rec[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert all(t >= 0 for t in rec.self_ns())


@pytest.fixture(scope="module")
def tiny2(tiny):
    """The tiny detector with the PDV second stage (chip_smoke's tiny RoI
    sizes)."""
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    cfg = dict(CFG, SECOND_STAGE=True, ROI_BUDGET=16, ROI_GRID_SIZE=3,
               ROI_ATTENTION=True)
    m = CenterPoint(cfg, 3, pc_range=(-3.2, -3.2, -2.0, 3.2, 3.2, 2.0),
                    voxel_size=(0.2, 0.2, 0.5), dtype=torch.float32,
                    device="cpu")
    m.init_parameters(torch.Generator().manual_seed(0))
    return m, tiny[1], tiny[2]


def test_two_stage_predict_span_tree(tiny2, monkeypatch):
    """The RoI head's spans nest in its stage: the keypoints, each level's
    pooling, the attention and the shared layers; the refined boxes stage
    holds none.  Without a recording the same predict reads no clock."""
    model, pts, valid = tiny2
    with profiling.recording() as rec:
        model.predict(pts[:1], valid[:1])
    prepare = ["    " + n.replace("vfe", "gather") for n in PREPARE]
    assert tree(rec) == ["predict", "  sample"] + prepare + [
        "    stack", "    backbone3d", "    bev+head", "    proposals",
        "    RoI head", "      bev keypoints", "      pool", "      pool",
        "      attention", "      shared fc", "    refined boxes"]
    assert [s.args for s in rec if s.name == "pool"] == [{"level": 0},
                                                          {"level": 1}]
    for s in rec:
        if s.parent is not None:
            p = rec[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    monkeypatch.setattr(profiling, "_clock", no_clock)
    out = model.predict(pts[:1], valid[:1])
    assert out["boxes"].shape == (1, 16, 7)


def test_train_step_span_tree(tiny):
    from detzero_tpu_torch.core.optim import build_optimizer
    from detzero_tpu_torch.parallel.trainer import Trainer

    model, pts, valid = tiny
    gb = torch.zeros(2, 4, 9)
    gb[:, 0, :7] = torch.tensor([1.0, 1.0, 0.0, 4.4, 2.0, 1.6, 0.3])
    gv = torch.zeros(2, 4, dtype=torch.bool)
    gv[:, 0] = True
    batch = dict(points=pts, points_valid=valid, gt_boxes=gb,
                 gt_classes=torch.zeros(2, 4, dtype=torch.int32),
                 gt_valid=gv)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, build_optimizer(
        {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
         "GRAD_NORM_CLIP": 10.0}, 5, model))
    try:
        trainer.step(batch)
        with profiling.recording() as rec:
            trainer.step(batch)
            trainer.step(batch)
    finally:
        model.load_state_dict(state)
    one = ["step"] + ["  " + n for n in PREPARE * 2] + [
        "  stack", "  backbone3d", "  bev+head", "  targets+loss",
        "  backward", "  optimizer"]
    assert tree(rec) == one + one
    steps = [s for s in rec if s.name == "step"]
    assert [s.args for s in steps] == [{"step_count": 1},
                                       {"step_count": 2}]
    assert [s.call for s in rec] == [0] * len(one) + [len(one)] * len(one)
    assert rec[len(one) - 1].end_ns == steps[0].end_ns   # optimizer ends
    # with its step


def test_spans_in_chrome_trace(tiny, tmp_path):
    model, pts, valid = tiny
    with profiling.trace(tmp_path):
        model.predict(pts[:1], valid[:1], score_thresh=0.0)
    assert profiling.ACTIVE is None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    regions = {e["name"] for e in events
               if e.get("cat") == "user_annotation"}
    assert {"predict", "sample index=0", "prepare index=0", "table",
            "plan", "row-pad maps", "vfe", "stack", "backbone3d",
            "bev+head", "decode+nms"} <= regions
    # a recording inside a capture keeps its spans and annotates them
    with profiling.trace(tmp_path / "again"):
        with profiling.recording() as rec:
            with profiling.span("outer"):
                rec.mark("inner")
    events = json.loads((tmp_path / "again" / "trace.json").read_text())
    regions = [e["name"] for e in events["traceEvents"]
               if e.get("cat") == "user_annotation"]
    assert "outer" in regions and "inner" in regions
    assert tree(rec) == ["outer", "  inner"]


def test_align_to_a_cpu_trace():
    """Under a CPU capture the recording probes the clock with regions;
    moved onto the trace's clock, each op's record lies in its stage."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            for i in range(4):
                with profiling.span("a", "index", i):
                    rec.mark("mm")
                    y = x @ x
                    rec.mark("sin")
                    y.sin()
    assert len(rec.probes) == 2 * profiling.PROBES
    records = profiling.host_records(prof)
    fit = profiling.align(rec, records)
    assert rec.clock == "trace" and fit["spread_ns"] == 0
    ops = [(n, t) for n, t in records if n in ("aten::mm", "aten::sin")]
    assert len(ops) == 8
    for name, t in ops:
        assert rec.innermost(t).name == name.split("::")[1]
    with pytest.raises(ValueError, match="trace's clock already"):
        profiling.align(rec, records)
    with profiling.recording() as bare:                 # no capture running
        pass
    assert bare.probes == []
    with pytest.raises(ValueError, match="probes"):
        profiling.align(bare, records)

"""The attribution rule of `benchmark/spans.py` on a hand-made trace: each
idle gap goes to the innermost span of the launch that ends it, the
charges add up to the idle time, the kernels launched in a span are
counted; the raw events read into ops and launch records; the readers of
the stretch's keys; and no keys, no extra runs, where the program has no
recorder (the parent's program under this benchmark)."""

import pytest

from benchmark import spans

# two calls of "predict", each a sample with two stages, then a launch
# outside any span (the harness's copy out)
SPANS = [("predict", 100, 400), ("sample", 110, 390),
         ("plan", 120, 200), ("backbone3d", 200, 390),
         ("predict", 500, 700), ("sample", 510, 690),
         ("plan", 520, 600), ("backbone3d", 600, 690)]
# (start, end, launch, is_kernel) on the card
OPS = [(1000, 1010, 130, True),     # first op: ends no gap
       (1010, 1030, 150, True),     # back to back: no gap
       (1050, 1060, 250, True),     # gap 20 -> backbone3d
       (1100, 1110, 105, True),     # gap 40 -> predict (its own time)
       (1105, 1120, 260, True),     # overlaps: no gap
       (1200, 1210, 450, False),    # gap 80 -> outside (a copy)
       (1300, 1310, 550, True),     # gap 90 -> plan
       (1400, 1405, None, True),    # gap 90 -> unlinked
       (1410, 1420, 650, True)]     # gap 5 -> backbone3d


def test_each_gap_goes_to_the_span_of_the_launch_that_ends_it():
    got = spans.attribute(OPS, SPANS)
    assert got["where"] == ["plan", "plan", "backbone3d", "predict",
                            "backbone3d", "outside", "plan", "unlinked",
                            "backbone3d"]
    assert got["wait_ns"] == {"backbone3d": 25, "predict": 40,
                              "outside": 80, "plan": 90, "unlinked": 90}


def test_the_charges_add_up_to_the_idle_time():
    got = spans.attribute(OPS, SPANS)
    first, last = min(o[0] for o in OPS), max(o[1] for o in OPS)
    busy = 30 + 10 + 20 + 10 + 10 + 5 + 10      # the union of the ops
    assert got["idle_ns"] == last - first - busy == 325
    assert sum(got["wait_ns"].values()) == got["idle_ns"]
    # the ops' order in the list does not matter
    again = spans.attribute(OPS[::-1], SPANS)
    assert again["wait_ns"] == got["wait_ns"]
    assert again["idle_ns"] == got["idle_ns"]


def test_kernels_launched_in_a_span_are_counted():
    got = spans.attribute(OPS, SPANS)
    # 9 ops: one a copy, one unlinked, one outside
    assert got["kernels"] == {"predict": 7, "sample": 6, "plan": 3,
                              "backbone3d": 3}


def test_boundaries_are_half_open():
    nest = [("a", 0, 10), ("b", 10, 20)]
    got = spans.attribute([(0, 1, 0, True), (5, 6, 10, True),
                           (9, 10, 20, True)], nest)
    assert got["where"] == ["a", "b", "outside"]


class Event:
    """A raw trace event as torch 2.11 gives it: no activity_type."""

    def __init__(self, name, device, kind, start, dur, corr,
                 annotation=False):
        self._v = (name, device, kind, start, dur, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        import torch

        return getattr(torch.autograd.DeviceType, self._v[1])

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


class KindEvent(Event):
    """One where torch names the activity's kind."""

    def activity_type(self):
        return self._v[2]


@pytest.mark.parametrize("cls", [Event, KindEvent])
def test_read_events(cls):
    events = [cls(*e) for e in [
        ("Activity Buffer Request", "CPU", "overhead", 50, 5, 0),
        ("cudaLaunchKernel", "CPU", "cuda_runtime", 100, 5, 7),
        ("cudaEventRecordWithFlags", "CPU", "cuda_runtime", 90, 2, 6),
        ("cuLaunchKernel", "CPU", "cuda_driver", 120, 5, 8),
        ("k", "CUDA", "kernel", 200, 10, 7),
        ("Memcpy HtoD (Pinned -> Device)", "CUDA", "gpu_memcpy", 230, 4, 8),
        ("predict", "CUDA", "gpu_user_annotation", 200, 40, 0, True)]]
    ops, launch, host = spans.read_events(events)
    assert ops == [(200, 210, 7, True, "k"),
                   (230, 234, 8, False, "Memcpy HtoD (Pinned -> Device)")]
    assert launch == {7: 100, 6: 90, 8: 120}
    assert ("cudaEventRecordWithFlags", 90) in host and len(host) == 4


def test_readers():
    rec = {"entry": "predict", "span_kernels": {"predict": 800.5},
           "span_wait_ms": {"table": 1.0, "plan": 2.0, "row-pad maps": 0.5,
                            "vfe": 0.25, "stack": 0.25, "backbone3d": 3.0,
                            "bev+head": 4.0, "decode+nms": 5.0,
                            "outside": 9.0}}
    assert spans.read("plan_wait_ms.predict", rec) == 4.0
    assert spans.read("backbone_wait_ms.predict", rec) == 3.0
    assert spans.read("head_nms_wait_ms.predict", rec) == 9.0
    assert spans.read("launches.predict", rec) == 800.5
    assert spans.read("plan_wait_ms.train", rec) is None
    train = {"entry": "train", "span_kernels": {"step": 10.0},
             "span_wait_ms": {"backward": 1.5, "optimizer": 0.5}}
    assert spans.read("backward_wait_ms.train", train) == 2.0
    assert spans.read("launches.train", train) == 10.0
    assert spans.read("backbone_wait_ms.train", train) == 0.0
    for name in spans.METRICS:
        assert spans.read(name, {"entry": spans.METRICS[name][0]}) is None
        assert spans.read(name, {"entry": "none"}) is None


def test_no_keys_without_a_recorder(monkeypatch):
    from detzero_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "recording")
    ran = []
    assert spans.stretch(ran.append, 2) == {}
    assert spans.on_cost(ran.append, 2) == {}
    # the harness's traced record comes back as it was, with no line
    traced = spans.with_spans(lambda run_one, n, hooked, n_host: {"k": n})
    assert traced(ran.append, 2, []) == {"k": 2}
    assert ran == []

"""The port's trace table (`detzero_tpu_torch.tools.analyze_trace`): the
per-op table of a Chrome trace, on a hand-made trace with known durations
(device kernels and a memcpy by card, host ops, regions and runtime
calls that nest, events of no plane), `.json.gz` and directory search,
`--plane` and `--top`; on a trace that `core/profiling.trace` writes on
the CPU; and run with tensorboard and tensorflow unimportable.  The
reference's tool reads XPlane protos through tensorflow and is not run."""

import gzip
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from detzero_tpu_torch.core import profiling
from detzero_tpu_torch.tools import analyze_trace

REPO = Path(__file__).resolve().parent.parent


def hand_trace():
    """Events with known durations (us): on cuda:0 kernel A 3 x 10, kernel
    B 5, a memcpy 2; on cuda:1 kernel A 7; on the host an 'aten::mm' 40
    inside a region 'step' 100, a launch 1; and events no plane takes (an
    instant, a python function, the card's copy of a region)."""
    ev = [{"ph": "X", "cat": "kernel", "name": "A", "dur": 10.0,
           "args": {"device": 0}} for _ in range(3)]
    ev += [{"ph": "X", "cat": "kernel", "name": "B", "dur": 5.0,
            "args": {"device": 0}},
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 2.0,
            "args": {"device": 0}},
           {"ph": "X", "cat": "kernel", "name": "A", "dur": 7.0,
            "args": {"device": 1}},
           {"ph": "X", "cat": "user_annotation", "name": "step", "dur": 100.0},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 40.0},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "dur": 1.0},
           {"ph": "i", "cat": "cpu_op", "name": "instant"},
           {"ph": "X", "cat": "python_function", "name": "f", "dur": 500.0},
           {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
            "dur": 99.0, "args": {"device": 0}}]
    return {"traceEvents": ev}


def test_hand_made_trace(tmp_path, capsys):
    (tmp_path / "a").mkdir()
    with gzip.open(tmp_path / "a" / "trace.json.gz", "wt") as f:
        json.dump(hand_trace(), f)
    (tmp_path / "notes.txt").write_text("not a trace")
    agg = analyze_trace.main([str(tmp_path)])
    assert list(agg) == ["/device:cuda:0", "/device:cuda:1", "/host:CPU"]
    assert dict(agg["/device:cuda:0"]) == {"A": [30.0, 3], "B": [5.0, 1],
                                           "Memcpy HtoD": [2.0, 1]}
    assert dict(agg["/device:cuda:1"]) == {"A": [7.0, 1]}
    assert dict(agg["/host:CPU"]) == {"step": [100.0, 1],
                                      "aten::mm": [40.0, 1],
                                      "cudaLaunchKernel": [1.0, 1]}
    out = capsys.readouterr().out
    assert "loaded 1 trace file(s)" in out
    assert "== /device:cuda:0  (3 distinct events, 0.037 ms summed)" in out
    # time_ms, share, count, mean_ms, name; ranked by time
    assert "     0.030   81.1%         3     0.0100  A" in out
    assert out.index("  A") < out.index("  B") < out.index("Memcpy HtoD")
    assert list(analyze_trace.main([str(tmp_path / "a" / "trace.json.gz"),
                                    "--plane", "HOST", "--top", "1"])) \
        == ["/host:CPU"]
    out = capsys.readouterr().out
    assert "step" in out and "aten::mm" not in out
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .json"):
        analyze_trace.main([str(tmp_path / "empty")])


def test_trace_of_core_profiling(tmp_path):
    """A trace `profiling.trace` writes on the CPU (a bare event list is
    read as well)."""
    x = torch.randn(64, 64)
    with profiling.trace(tmp_path / "prof"):
        with profiling.annotate("step", step_num=1):
            (x @ x).sum()
    agg = analyze_trace.aggregate(analyze_trace.trace_files(tmp_path))
    host = agg["/host:CPU"]
    assert host["step step_num=1"][1] == 1
    assert host["aten::mm"][1] >= 1
    assert host["step step_num=1"][0] >= host["aten::mm"][0] > 0
    events = analyze_trace.load_events(tmp_path / "prof" / "trace.json")
    (tmp_path / "bare.json").write_text(json.dumps(events))
    again = analyze_trace.aggregate([tmp_path / "bare.json"])
    assert {k: dict(v) for k, v in again.items()} == \
        {k: dict(v) for k, v in agg.items()}


def test_runs_without_tensorflow_or_tensorboard(tmp_path):
    (tmp_path / "t.json").write_text(json.dumps(hand_trace()))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('tensorflow', 'tensorboard'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from detzero_tpu_torch.tools import analyze_trace\n"
        f"analyze_trace.main([{str(tmp_path / 't.json')!r}])\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('tensorflow', 'tensorboard')]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "/device:cuda:0" in r.stdout

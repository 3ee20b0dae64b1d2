"""BENCHMARK.json against the benchmark's files: every cell, configuration,
mix and metric resolves by name, the names and units keep the allowed
alphabet, and each configuration file says what the repo's yaml says."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness, resolve

ROOT = Path(__file__).resolve().parents[2]
BJ = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BJ["workloads"]]
METRICS = BJ["end_to_end"] + BJ["per_layer"]


def test_top_level_keys():
    assert set(BJ) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BJ["paths"] == ["benchmark"]
    assert BJ["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BJ["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    w = next(w for w in BJ["workloads"] if w["name"] == name)
    cell = resolve.cell(name)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        w["config"], w["traffic"], w["chips"])
    assert cell["why"] == w["why"] and len(w["why"]) <= 200
    entry = harness.Run(cell, 0, 0, False, "cpu", 0.0).entry
    assert entry.KIND in ("predict", "train") and callable(entry.run)
    assert cell["limits"]
    # every cell reports set-up, one other end-to-end and a per-layer metric
    e2e = [m["name"] for m in BJ["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(name in m.get("workloads", CELLS) for m in BJ["per_layer"])


def test_unknown_entry_raises(tmp_path):
    (tmp_path / "entries").mkdir()
    with pytest.raises(ValueError, match="not built in"):
        resolve.entry("no_such_entry", base=tmp_path)
    cell = dict(resolve.cell(CELLS[0]), entry="no_such_entry")
    with pytest.raises(ValueError, match="not built in"):
        harness.Run(cell, 0, 0, False, "cpu", 0.0)


@pytest.mark.parametrize("cfg", BJ["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = ROOT / cfg["file"]
    assert cfg["file"].startswith("benchmark/configs/")
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BJ["workloads"])


@pytest.mark.parametrize("m", BJ["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(m):
    reader = resolve.metric_reader(m["name"])
    assert reader.UNIT == m["unit"]
    assert reader.read({"entry": "none"}) is None
    assert m["moves"] in [e["name"] for e in BJ["end_to_end"]]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    for w in m.get("workloads", []):
        assert w in CELLS


def test_bounds():
    for m in BJ["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BJ["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("cfg", BJ["configs"], ids=lambda c: c["name"])
def test_config_agrees_with_yaml(cfg):
    """The configuration as run holds every value of the repo's yaml that
    the detector reads (a run refuses to start where it does not)."""
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["mirrors"]
    assert resolve.yaml_drift(data) == []
    drifted = dict(data, MODEL=dict(data["MODEL"], VOXEL_CAPACITIES=[1]))
    assert resolve.yaml_drift(drifted) == ["MODEL.VOXEL_CAPACITIES"]

"""Finds a cell's files by name: `cells/<cell>.json` names its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<mix>.json`), its entry (`predict`, `train` or
`entries/<entry>.py`), the chips it asks for and the limits of its
comparisons; `metrics/<metric>.py` reads one per-layer metric.  A new cell,
configuration, mix, entry or metric is a new file: nothing here lists
them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(name, base=HERE):
    """The cell's dict, with its config and mix dicts under "config_data"
    and "mix_data"."""
    c = _json(base / "cells" / f"{name}.json")
    c["name"], c["base"] = name, Path(base)
    c["config_data"] = _json(base / "configs" / f"{c['config']}.json")
    c["mix_data"] = _json(base / "traffic" / f"{c['traffic']}.json")
    return c


def _module(kind, name, path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name, base=HERE):
    """The module of `metrics/<name>.py`: `read(record)` -> value or None,
    and `UNIT`."""
    return _module("metric", name, base / "metrics" / f"{name}.py")


def entry(name, base=HERE):
    """The module of `entries/<name>.py` under `base`, for a cell whose
    entry is not one of the harness's own (`harness.ENTRIES`: `predict`,
    `train`).  It gives `KIND` ("predict" or "train": the traced record's
    "entry", which the metric readers key on) and `run(run)` -> (attempted,
    failed, numbers, memory peak), `run` being a `harness.Run`; it may give
    `control(cell, seed, device)` -> numbers, the control's readings for
    `calibrate.py`."""
    path = Path(base) / "entries" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"entry {name!r} is not built in and there is no "
                         f"file {path}")
    return _module("entry", name, path)


def benchmark_json(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    return _json(path) if path.exists() else None


def _applies(entry, cell_name):
    return "workloads" not in entry or cell_name in entry["workloads"]


def per_layer_metrics(cell_name, base=HERE, root=ROOT):
    """(name, unit) of the per-layer metrics this cell reports: those of
    BENCHMARK.json that list it (or list no cells); every reader under
    metrics/ where BENCHMARK.json does not name the cell."""
    bj = benchmark_json(root)
    if bj is not None and any(cell_name == w["name"]
                              for w in bj["workloads"]):
        return [(m["name"], m["unit"]) for m in bj["per_layer"]
                if _applies(m, cell_name)]
    return [(p.stem, metric_reader(p.stem, base).UNIT)
            for p in sorted((base / "metrics").glob("*.py"))]


def end_to_end_metrics(cell_name, produced, root=ROOT):
    """The end-to-end metrics of `produced` ({name: (value, unit)}) that
    BENCHMARK.json gives this cell; all of them where it does not name the
    cell."""
    bj = benchmark_json(root)
    if bj is None or not any(cell_name == w["name"]
                             for w in bj["workloads"]):
        return dict(produced)
    return {m["name"]: produced[m["name"]] for m in bj["end_to_end"]
            if _applies(m, cell_name) and m["name"] in produced}


def yaml_drift(config, root=ROOT):
    """The keys of a configuration file whose values differ from the repo's
    yaml it names first under "mirrors", read by the port's loader; [] where
    it names none.  The file is the configuration as run; this keeps the
    program's own copy from drifting away from it unseen."""
    if not config.get("mirrors"):
        return []
    from detzero_tpu_torch.core.config import cfg_from_yaml_file

    yaml = cfg_from_yaml_file(str(Path(root) / config["mirrors"][0]))

    def plain(v):
        return [plain(x) for x in v] if isinstance(v, (list, tuple)) else v

    voxel = next(p for p in yaml["DATA_PROCESSOR"]
                 if p["NAME"].startswith("transform_points_to_voxels"))
    pairs = [(k, config.get(k), yaml[k]) for k in (
        "CLASS_NAMES", "POINT_CLOUD_RANGE", "NUM_POINT_BUDGET", "MAX_OBJS")]
    pairs += [("VOXEL_SIZE", config.get("VOXEL_SIZE"), voxel["VOXEL_SIZE"]),
              ("used_feature_list", config.get("used_feature_list"),
               yaml["POINT_FEATURE_ENCODING"]["used_feature_list"])]
    model, opt = config.get("MODEL", {}), config.get("OPTIMIZATION", {})
    for k, v in yaml["MODEL"].items():
        if k == "POST_PROCESSING":
            pairs += [(f"MODEL.{k}.{kk}", model.get(k, {}).get(kk), vv)
                      for kk, vv in v.items()]
        else:
            pairs.append((f"MODEL.{k}", model.get(k), v))
    pairs += [(f"OPTIMIZATION.{k}", opt.get(k), v)
              for k, v in yaml["OPTIMIZATION"].items()]
    return [k for k, got, want in pairs if plain(got) != plain(want)]

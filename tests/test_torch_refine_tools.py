"""The refining stage's entry points of the port on the CPU, and the slice
as a whole against the reference:

  * the daemon's records -> datasets -> BatchedRefiner -> result pickles:
    the reference's tools/test_refine.py on a flax checkpoint against the
    port's `test_refine.main` on a torch checkpoint of the converted
    weights, for GRM, PRM and CRM, and with --tta for GRM and PRM: the
    saved pickles within 1e-5 * max(|ref|, 1) (under --tta on the first
    4 tracks: the reference fans each track out op by op);
  * `train_refine.main` on configs/ref_model_cfgs/synthetic_{grm,prm,crm}
    .yaml with --device cpu, resuming;
  * `prepare_object_data.main` on a tracking pickle, and the refusals.
"""

import json
import pickle
import sys

import numpy as np
import pytest

import jax
import torch

from detzero_tpu.core.checkpoint import CheckpointManager as RefCkpt
from detzero_tpu_torch.core.checkpoint import CheckpointManager
from detzero_tpu_torch.pipeline import daemon
from detzero_tpu_torch.tools import (
    prepare_object_data, test_refine, train_refine,
)
from tools import common as ref_common
from tools import test_refine as ref_test_refine
from tools import train_refine as ref_train_refine

import torch_refine_cases as cases
from test_torch_refine_data import scene
from test_torch_refining import close, port_model, ref_model

torch.set_num_threads(1)
KINDS = ("grm", "prm", "crm")
DATASET = {"grm": ("WaymoGeometryDataset", {"QUERY_NUM": 3,
                                            "QUERY_POINTS": 16,
                                            "MEMORY_POINTS": 64,
                                            "POINT_FEATURES": 11}),
           "prm": ("WaymoPositionDataset", {"QUERY_NUM": 12,
                                            "QUERY_POINTS": 16,
                                            "MEMORY_POINTS": 4,
                                            "POINT_FEATURES": 32}),
           "crm": ("WaymoConfidenceDataset", {"QUERY_NUM": 12,
                                              "QUERY_POINTS": 16,
                                              "POINT_FEATURES": 32})}


def write_tree(root):
    """Two sequences of the daemon's per-class pickles (6 Vehicle tracks
    of 8 frames each)."""
    for s, seq in enumerate(("seq_a", "seq_b")):
        (root / "Vehicle").mkdir(parents=True, exist_ok=True)
        with open(root / "Vehicle" / f"{seq}.pkl", "wb") as f:
            pickle.dump(cases.object_records(20 + s), f)
    return root


def write_cfg(path, kind, data_path):
    name, ds = DATASET[kind]
    cfg = {"CLASS_NAME": "Vehicle", "DATASET": name,
           "DATA_PATH": str(data_path), **ds,
           "MODEL": cases.ref_cfg(kind)["MODEL"]}
    path.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in
                            cfg.items()))
    return path


def assert_pickles_close(a, b):
    assert set(a) == set(b)
    for seq in a:
        assert set(a[seq]) == set(b[seq]), seq
        for oid in a[seq]:
            ra, rb = a[seq][oid], b[seq][oid]
            assert set(ra) == set(rb)
            for k in ra:
                assert close(ra[k], rb[k], 1e-5), (seq, oid, k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("refining"))


@pytest.mark.parametrize("kind,tta", [("grm", False), ("prm", False),
                                      ("crm", False), ("grm", True),
                                      ("prm", True)])
def test_test_refine_equals_the_reference(kind, tta, tree, tmp_path,
                                          monkeypatch):
    cfg = write_cfg(tmp_path / f"tiny_{kind}.yaml", kind, tree)
    jm = ref_model(kind)
    v = cases.flax_variables(jm, kind, seed=3)
    RefCkpt(tmp_path / "ref_ckpt").save(1, {"params": v["params"],
                                            "batch_stats": {}})
    model = port_model(kind, v)
    CheckpointManager(tmp_path / "ckpt").save(1, {"model":
                                                  model.state_dict()})
    extra = ["--tta", "--max_tracks", "4"] if tta else []
    # the reference's CLI would also point jax's persistent compilation
    # cache into the checkout; the tests run on the CPU backend as set up
    monkeypatch.setattr(ref_common, "apply_platform", lambda args: None)
    # its init only sizes the variables that the checkpoint then replaces:
    # jitted, it takes a second where the eager one takes ten
    build = ref_train_refine.build_refine_model

    def jitted_init(cfg):
        m = build(cfg)
        object.__setattr__(m, "init", jax.jit(m.init))
        return m

    monkeypatch.setattr(ref_train_refine, "build_refine_model", jitted_init)
    monkeypatch.setattr(sys, "argv", [
        "test_refine.py", "--cfg_file", str(cfg), "--ckpt",
        str(tmp_path / "ref_ckpt"), "--output_dir", str(tmp_path / "ref"),
        "--batch_size", "4", "--save_to_file", *extra])
    ref_test_refine.main()
    res = test_refine.main([
        "--cfg_file", str(cfg), "--ckpt", str(tmp_path / "ckpt"),
        "--output_dir", str(tmp_path / "port"), "--batch_size", "4",
        "--save_to_file", "--device", "cpu", *extra])
    stage = test_refine.STAGE[cases.NAMES[kind]]
    name = f"Vehicle_{stage}_val.pkl"
    want = pickle.loads((tmp_path / "ref" / cfg.stem / "default" / name)
                        .read_bytes())
    assert res["result_path"] == tmp_path / "port" / cfg.stem / "default" \
        / name
    got = pickle.loads(res["result_path"].read_bytes())
    n = 4 if tta else 12
    assert res["step"] == 1 and res["timings"]["tracks"] == n
    assert sum(len(r) for r in got.values()) == n
    assert res["boxes"] > 0 and 0 <= res["recall_out"] <= 1
    assert_pickles_close(want, got)


def train_tree(root, n=20):
    """One sequence of n Vehicle tracks (18 matched) for the synthetic
    configs' batches (16 for GRM)."""
    (root / "Vehicle").mkdir(parents=True)
    with open(root / "Vehicle" / "seq0.pkl", "wb") as f:
        pickle.dump(cases.object_records(5, n=n, t=8), f)
    return root


@pytest.mark.parametrize("kind", KINDS)
def test_train_refine_cli_resumes(kind, tmp_path):
    data = train_tree(tmp_path / "data")
    args = ["--cfg_file", f"configs/ref_model_cfgs/synthetic_{kind}.yaml",
            "--device", "cpu", "--workers", "0", "--output_dir",
            str(tmp_path / "out"), "--log_every", "1"]
    overrides = ["--set", "DATA_PATH", str(data)]
    trainer = train_refine.main(args + ["--max_steps", "1"] + overrides)
    assert trainer.step_count == 1
    assert trainer.model.__class__.__name__ == cases.NAMES[kind]
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
    trainer = train_refine.main(args + ["--max_steps", "2"] + overrides)
    assert trainer.step_count == 2
    exp = tmp_path / "out" / f"synthetic_{kind}" / "default" / "ckpt"
    assert CheckpointManager(exp).all_steps() == [1, 2]
    lines = [json.loads(x) for x in
             (exp / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(v) for x in lines for v in x.values())


def test_train_refine_refusals(tmp_path, monkeypatch):
    data = train_tree(tmp_path / "data", n=6)      # 4 matched: no batch
    args = ["--cfg_file", "configs/ref_model_cfgs/synthetic_grm.yaml",
            "--output_dir", str(tmp_path / "out"), "--workers", "0"]
    with pytest.raises(train_refine.TooFewTracks,
                       match="cannot fill one batch of 16"):
        train_refine.main(args + ["--device", "cpu", "--set", "DATA_PATH",
                                  str(data)])
    empty = tmp_path / "empty"
    empty.mkdir()
    assert train_refine.main(args + ["--device", "cpu", "--set",
                                     "DATA_PATH", str(empty)]) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train_refine.main, test_refine.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(args + ["--set", "DATA_PATH", str(data)])


def test_prepare_object_data_cli(tmp_path):
    tr, frames, poses, _ = scene(seed=2)
    with open(tmp_path / "tracking.pkl", "wb") as f:
        pickle.dump({"seq0": tr}, f)
    with open(tmp_path / "seq0.pkl", "wb") as f:
        pickle.dump({"points": frames, "poses": poses}, f)
    before = daemon.NATIVE_FRAMES
    written = prepare_object_data.main([
        "--track_path", str(tmp_path / "tracking.pkl"), "--points_root",
        str(tmp_path), "--output_dir", str(tmp_path / "out")])
    assert daemon.NATIVE_FRAMES - before == 5
    assert sorted(written) == ["Cyclist", "Pedestrian", "Vehicle"]
    recs = daemon.prepare_object_data(tr, frames, poses)
    for cls, label in (("Vehicle", 0), ("Pedestrian", 1), ("Cyclist", 2)):
        got = pickle.loads(written[cls]["seq0"].read_bytes())
        assert sorted(got) == sorted(k for k, r in recs.items()
                                     if r["label"] == label)
        for k in got:
            for a, b in zip(got[k]["pts"], recs[k]["pts"]):
                assert np.array_equal(a, b)

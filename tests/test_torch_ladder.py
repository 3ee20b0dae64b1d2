"""The synthetic quality ladder of the port
(`detzero_tpu_torch.tools.ladder_synthetic`) against the JAX tool
(`tools/ladder_synthetic.py`) on the CPU, at a tiny geometry on
configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml (a 64 x 64 x 8 grid,
1,024 points, one BEV layer a level), float32 on both sides (`run_det` itself: tests/test_torch_ladder_det.py):

  * `build_synthetic` scenes equal bit for bit, train and val seed;
  * the three modes from the same detections (both tools' `run_det`
    stubbed with GT-derived detections of one sequence, so that tracks
    match GT) and the same tiny refiners (D_MODEL 32, the reference's flax
    weights carried across by `convert_refiner`; the reference's loader
    stubbed): `--make_refine_data` writes the same files and track ids,
    every record equal (floats within 1e-6); `--relabel_crm` the same
    iou_gt within 1e-5; the ladder the same 4-row table at 4 decimals;
  * the default `--out_md` is LADDER_TORCH.md, not the reference's
    LADDER.md, and `--device cuda` without a card raises.
"""

import json
import pickle
import shutil
import sys

import numpy as np
import pytest

import jax
import torch

from detzero_tpu.core.config import Config as RefConfig
from detzero_tpu.core.config import cfg_from_yaml_file as ref_cfg_from_yaml
from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
from detzero_tpu_torch.tools import ladder_synthetic
from detzero_tpu_torch.tools import run_offboard
from tools import ladder_synthetic as ref_ladder
from tools import run_offboard as ref_run_offboard

import torch_refine_cases as cases
from test_torch_refining import port_model, ref_model

torch.set_num_threads(1)

BASE = "configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml"
OVERRIDES = {"POINT_CLOUD_RANGE": [-6.4, -6.4, -1.6, 6.4, 6.4, 1.6],
             "NUM_POINT_BUDGET": 1024, "SYNTHETIC_POINTS": 1024}
MODEL_OVERRIDES = {"MAX_VOXELS": 1024, "BEV_LAYER_NUMS": [1, 1],
                   "VOXEL_CAPACITIES": [1024, 512, 256, 128]}
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
SAMPLERS = {"grm": {"query_num": cases.Q, "query_points": cases.NP,
                    "memory_points": cases.M},
            "prm": {"query_num": 20, "query_points": cases.NP,
                    "memory_points": cases.NM}}
# PRM and CRM take a whole track of 16 frames (the sequence)
SAMPLERS["crm"] = SAMPLERS["prm"]
TRAIN_SEED, VAL_SEED = 0, 1234


def write_cfg(tmp_path):
    lines = [f"_BASE_CONFIG_: {BASE}"]
    lines += [f"{k}: {json.dumps(v)}" for k, v in OVERRIDES.items()]
    lines += ["MODEL:"] + [f"  {k}: {json.dumps(v)}"
                           for k, v in MODEL_OVERRIDES.items()]
    path = tmp_path / "ladder_tiny.yaml"
    path.write_text("\n".join(lines) + "\n")
    return path


def gt_detections(cfg, seed, rng):
    """One sequence's detections in run_det's schema, made from its GT:
    90% of the objects, jittered, scored 0.5-1, and two false positives a
    frame scored 0.05-0.5."""
    ds = ladder_synthetic.build_synthetic(cfg, seed, 1)
    annos = []
    for i in range(len(ds)):
        _, b, n = ds.generate_scene(i)
        keep = rng.rand(len(b)) > 0.1
        k = int(keep.sum())
        bb = b[keep].copy()
        bb[:, :3] += rng.randn(k, 3).astype(np.float32) * 0.15
        bb[:, 3:6] *= rng.uniform(0.9, 1.1, (k, 3)).astype(np.float32)
        bb[:, 6] += rng.randn(k).astype(np.float32) * 0.05
        fp = np.concatenate([rng.uniform(-5, 5, (2, 2)), np.zeros((2, 1)),
                             rng.uniform(0.8, 4, (2, 3)),
                             rng.uniform(-3, 3, (2, 1))], 1)
        annos.append({
            "name": np.concatenate([n[keep], rng.choice(CLASSES, 2)]),
            "score": np.concatenate([rng.uniform(0.5, 1, k),
                                     rng.uniform(0.05, 0.5, 2)]),
            "boxes_lidar": np.concatenate([bb, fp]).astype(np.float32),
            "frame_id": i, "sequence_name": f"synthetic_{i // 16:03d}",
            "pose": np.eye(4, dtype=np.float32)})
    return annos


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The yaml, both packages' configs, the refiners, and GT-derived
    detections of the train and val seeds."""
    tmp = tmp_path_factory.mktemp("ladder")
    path = write_cfg(tmp)
    cfg = cfg_from_yaml_file(str(path), Config())
    ref_cfg = ref_cfg_from_yaml(str(path), RefConfig())
    ref, port = {}, {}
    for seed, kind in enumerate(("grm", "prm", "crm")):
        jm = ref_model(kind)
        fv = cases.flax_variables(jm, kind, seed=seed)
        ref[kind] = (jm, {"params": fv["params"]}, SAMPLERS[kind])
        port[kind] = (port_model(kind, fv), SAMPLERS[kind])
    rng = np.random.RandomState(0)
    dets = {s: gt_detections(cfg, s, rng) for s in (TRAIN_SEED, VAL_SEED)}
    return {"tmp": tmp, "path": path, "cfg": cfg, "ref_cfg": ref_cfg,
            "ref": ref, "port": port, "dets": dets}


def apply_stubs(setup, mp):
    """Both tools' run_det return the GT-derived detections of the
    dataset's seed; the refiners load from memory by kind (the spec's
    checkpoint path names it); the reference's jax config calls are
    no-ops."""
    def fake_run_det(cfg, ckpt, dataset, logger, *a, **kw):
        return [dict(d) for d in setup["dets"][dataset.seed]]

    mp.setattr(ladder_synthetic, "run_det", fake_run_det)
    mp.setattr(ref_ladder, "run_det", fake_run_det)
    mp.setattr(ref_run_offboard, "_load_refine",
               lambda cfg, ck: setup["ref"][ck.split("/")[0]])
    mp.setattr(run_offboard, "load_refiner",
               lambda cfg, ck, device: setup["port"][ck.split("/")[0]])
    mp.setattr(jax.config, "update", lambda *a, **k: None)


@pytest.fixture
def stubs(setup, monkeypatch):
    apply_stubs(setup, monkeypatch)


def run_ref(monkeypatch, args):
    monkeypatch.setattr(sys, "argv", ["ladder_synthetic.py", *args])
    ref_ladder.main()


def test_build_synthetic_bit_equal(setup):
    for seed in (TRAIN_SEED, VAL_SEED):
        want = ref_ladder.scene_tables(ref_ladder.build_synthetic(
            setup["ref_cfg"], seed, 1))
        got = ladder_synthetic.scene_tables(ladder_synthetic.build_synthetic(
            setup["cfg"], seed, 1))
        assert [len(t) for t in got] == [16] * 3
        for w, g in zip(want, got):
            for a, b in zip(w, g):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def assert_close_tree(a, b, tol, path=""):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_close_tree(a[k], b[k], tol, f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close_tree(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=path)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def refine_data(setup):
    """The records of both tools' --make_refine_data (train seed), under
    tmp/ref_data and tmp/port_data."""
    mp = pytest.MonkeyPatch()
    try:
        apply_stubs(setup, mp)
        out = {}
        for who in ("ref", "port"):
            d = setup["tmp"] / f"{who}_data"
            args = ["--cfg_file", str(setup["path"]), "--ckpt", "unused",
                    "--n_seq", "1", "--train_seed", str(TRAIN_SEED),
                    "--make_refine_data", str(d)]
            if who == "ref":
                run_ref(mp, args)
            else:
                out["n"] = ladder_synthetic.main(args + ["--device", "cpu"])
            out[who] = d
    finally:
        mp.undo()
    return out


def load_records(root):
    return {str(p.relative_to(root)): pickle.loads(p.read_bytes())
            for p in sorted(root.glob("*/*.pkl"))}


def test_make_refine_data_equal(refine_data):
    want, got = (load_records(refine_data[w]) for w in ("ref", "port"))
    assert list(got) == list(want)
    assert {f.split("/")[0] for f in got} >= {"Vehicle", "Pedestrian"}
    for f in want:
        assert list(got[f]) == list(want[f])
        assert_close_tree(want[f], got[f], 1e-6, f)
    n = refine_data["n"]["n_records"]
    assert sum(n.values()) == sum(len(r) for r in got.values())
    matched = [r for recs in got.values() for r in recs.values()
               if (np.asarray(r["iou_gt"]) > 0).any()]
    assert matched


def test_relabel_crm_equal(setup, stubs, refine_data, monkeypatch):
    """GRM and PRM per class (Vehicle only: the other classes keep their
    boxes) refine the records; both tools' new iou_gt within 1e-5."""
    before = load_records(refine_data["port"])
    dirs = {}
    for who in ("ref", "port"):
        dirs[who] = setup["tmp"] / f"{who}_relabel"
        shutil.copytree(refine_data[who], dirs[who])
        args = ["--cfg_file", str(setup["path"]), "--ckpt", "unused",
                "--relabel_crm", str(dirs[who]),
                "--grm", "Vehicle=g.yaml:grm/v", "--prm", "Vehicle=p.yaml:prm/v"]
        if who == "ref":
            run_ref(monkeypatch, args)
        else:
            res = ladder_synthetic.main(args + ["--device", "cpu"])
            assert len(res["relabeled"]) == len(before)
    want, got = (load_records(dirs[w]) for w in ("ref", "port"))
    changed = 0
    for f in want:
        assert list(got[f]) == list(want[f])
        for oid in want[f]:
            a = np.asarray(want[f][oid]["iou_gt"])
            b = np.asarray(got[f][oid]["iou_gt"])
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
            changed += not np.array_equal(
                b, np.asarray(before[f][oid]["iou_gt"]))
    assert changed


def test_ladder_table_equal(setup, stubs, monkeypatch):
    """The 4-row table from the same val detections and refiners (one
    model a stage for every class), equal at 4 decimals."""
    tables = {}
    for who in ("ref", "port"):
        md = setup["tmp"] / f"{who}_ladder.md"
        args = ["--cfg_file", str(setup["path"]), "--ckpt", "unused",
                "--n_seq", "1", "--val_seed", str(VAL_SEED),
                "--out_md", str(md)]
        for kind in ("grm", "prm", "crm"):
            args += [f"--{kind}_cfg", f"{kind}.yaml", f"--{kind}_ckpt",
                     f"{kind}/all"]
        if who == "ref":
            run_ref(monkeypatch, args)
        else:
            res = ladder_synthetic.main(args + ["--device", "cpu"])
        tables[who] = md.read_text().split("\n\n", 2)[-1].strip()
    assert tables["port"] == tables["ref"] == res["table"]
    assert [name for name, _ in res["rows"]] == ["DET", "+TRK", "+GRM/PRM",
                                                 "+CRM"]
    assert res["rows"][0][1]["mean"]["AP_L2"] > 0.1
    assert set(res["timings"]) >= {"+TRK", "+GRM/PRM", "+CRM"}


def test_out_md_default_and_device_refusal(setup, monkeypatch):
    args = ladder_synthetic.parse_args(["--ckpt", "x"])
    assert args.out_md == "LADDER_TORCH.md" == ladder_synthetic.DEFAULT_OUT_MD
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ([], ["--relabel_crm", str(setup["tmp"])],
                 ["--make_refine_data", str(setup["tmp"] / "never")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ladder_synthetic.main(["--cfg_file", str(setup["path"]),
                                   "--ckpt", str(setup["tmp"]), *mode])
    assert not (setup["tmp"] / "never").exists()


def test_run_recipe(setup, stubs, monkeypatch):
    """run_recipe (run_synthetic_ladder.sh's steps; detections as above,
    train_refine.main stubbed: Vehicle trains, Pedestrian's tracks cannot
    fill a batch, Cyclist has no records): the records of the train seed,
    GRM and PRM a class at batch 4, the relabel with the trained GRM/PRM,
    CRM, then the ladder on the val seed with each stage's trained classes
    in one --<kind> occurrence and its table appended to --out_md."""
    from pathlib import Path

    from detzero_tpu_torch.tools import train_refine

    events, stage_args = [], []

    def fake_train(argv):
        arg = {k: argv[argv.index(k) + 1] for k in (
            "--cfg_file", "--extra_tag", "--max_steps", "--batch_size",
            "--device")}
        kind, cls = Path(arg["--cfg_file"]).stem[-3:], arg["--extra_tag"]
        events.append((kind, cls))
        assert (arg["--max_steps"], arg["--batch_size"], arg["--device"]) \
            == ("3", "4", "cpu")
        assert argv[argv.index("DATA_PATH") + 1] == str(work / "refine_data")
        if cls == "Pedestrian":
            raise train_refine.TooFewTracks(
                "3 training tracks cannot fill one batch of 4")
        return None if cls == "Cyclist" else object()

    relabel, load = ladder_synthetic.relabel_crm, ladder_synthetic.load_stages

    def spy_relabel(*a):
        events.append("relabel")
        return relabel(*a)

    def spy_load(args, device, kinds, logger):
        stage_args.append({k: getattr(args, k) for k in kinds})
        return load(args, device, kinds, logger)

    monkeypatch.setattr(train_refine, "main", fake_train)
    monkeypatch.setattr(ladder_synthetic, "relabel_crm", spy_relabel)
    monkeypatch.setattr(ladder_synthetic, "load_stages", spy_load)
    monkeypatch.setattr(run_offboard, "load_refiner",
                        lambda cfg, ck, device:
                        setup["port"][Path(cfg).stem[-3:]])
    work = setup["tmp"] / "recipe"
    md = setup["tmp"] / "recipe.md"
    res = ladder_synthetic.main(
        ["--recipe", str(work), "--cfg_file", str(setup["path"]), "--ckpt",
         "unused", "--device", "cpu", "--train_n_seq", "1", "--n_seq", "1",
         "--refine_steps", "3", "--out_md", str(md)])
    classes = ("Vehicle", "Pedestrian", "Cyclist")
    assert events == [(k, c) for k in ("grm", "prm") for c in classes] \
        + ["relabel"] + [("crm", c) for c in classes]
    for kind, trained in res["refiners"].items():
        spec = (f"Vehicle={ladder_synthetic.REFINE_CFG.format(kind)}:"
                f"{work / 'models' / f'synthetic_{kind}' / 'Vehicle' / 'ckpt'}")
        assert trained == {
            "Vehicle": {"spec": spec, "ckpt": Path(spec.split(":", 1)[1]),
                        "seconds": trained["Vehicle"]["seconds"]},
            "Pedestrian": {"skipped":
                           "3 training tracks cannot fill one batch of 4"},
            "Cyclist": {"skipped": "no records"}}
        assert stage_args[-1][kind] == [spec]
    assert stage_args[0] == {"grm": [spec.replace("crm", "grm")],
                             "prm": [spec.replace("crm", "prm")]}
    assert res["relabel_changed"] > 0
    assert sum(res["records"]["n_records"].values()) > 0
    assert [n for n, _ in res["ladder"]["rows"]] == ["DET", "+TRK",
                                                     "+GRM/PRM", "+CRM"]
    assert md.read_text().split("\n\n", 2)[-1].strip() == \
        res["ladder"]["table"]
    assert set(res["seconds"]) == {"records", "grm", "prm", "relabel",
                                   "crm", "ladder"}

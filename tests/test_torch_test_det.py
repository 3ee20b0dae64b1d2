"""The detection inference entry point of the port on the CPU, the slice as
a whole: `detzero_tpu_torch.tools.test_det.run_inference` on a tiny
Waymo-layout tree (tests/torch_data_cases.py, read through the native
loader) with the model of configs/det_model_cfgs/
centerpoint_synthetic_cpu.yaml at the tree's geometry, against the
reference's inference loop (tools/test_det.py: CenterPoint.predict ->
generate_prediction_dicts -> with TTA invert_boxes and wbf_online) on the
reference's variables carried across by convert.py, float32 on both
sides: the same frames, names, labels and keep counts, boxes within 1e-3
(the bound of tests/test_torch_centerpoint.py::test_predict_end_to_end),
with and without TTA; both packages' detections scored equally by the
port's evaluation and the reference's evaluator; and the CLI (`main`:
--save_to_file read by the reference's run_track, --eval_all, and its
refusals)."""

import json
import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.core.config import Config as RefConfig
from detzero_tpu.core.config import cfg_from_yaml_file as ref_cfg_from_yaml
from detzero_tpu.data import tta as ref_tta
from detzero_tpu.data import waymo_dataset as ref_waymo
from detzero_tpu.ops import wbf as ref_wbf
from detzero_tpu.pipeline import evaluator as ref_evaluator
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
from detzero_tpu_torch.data import waymo_dataset
from detzero_tpu_torch.tools import common, test_det
from tools import common as ref_common

import torch_data_cases as cases
from test_torch_convert import randomize_stats

torch.set_num_threads(1)

BASE = "configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml"
# the base config on the tiny tree: its dataset, 2 sweeps and geometry
# (the tree's points cover its range, so no two BEV cells see the same
# empty input and tie), a score threshold of 0 so random weights keep
# boxes, one BEV layer a level, and 64 pillars a BEV row: the width of
# the grid, so no row overflows (the base config's BACKBONE3D 'pillar'
# has no row budget in the reference; the port runs it on the row-pad
# backbone, which drops a row's pillars beyond the budget: ROADMAP
# queue 3)
OVERRIDES = {"DATASET": "WaymoDetectionDataset", "SWEEP_COUNT": [-1, 0],
             "DATA_SPLIT": {"train": "train", "test": "train"},
             "USE_NATIVE_LOADER": True,
             "POINT_CLOUD_RANGE": cases.PC_RANGE, "NUM_POINT_BUDGET": 2048,
             "DATA_PROCESSOR": cases.tree_cfg("")["DATA_PROCESSOR"]}
MODEL_OVERRIDES = {"PILLAR_ROW_BUDGET": 64, "BEV_LAYER_NUMS": [1, 1],
                   "POST_PROCESSING": {"SCORE_THRESH": 0.0,
                                       "NMS_THRESH": 0.7,
                                       "NMS_PRE_MAXSIZE": 1024,
                                       "NMS_POST_MAXSIZE": 64}}
TTA_LIST = ["rot_0.39269908"]


def write_cfg(tmp_path, tree, **extra):
    """A yaml on BASE pointing at `tree` (the lists and maps in flow
    style, which both packages' loaders read)."""
    lines = [f"_BASE_CONFIG_: {BASE}", f"DATA_PATH: {json.dumps(str(tree))}"]
    lines += [f"{k}: {json.dumps(v)}" for k, v in {**OVERRIDES,
                                                   **extra}.items()]
    lines += ["MODEL:"] + [f"  {k}: {json.dumps(v)}"
                           for k, v in MODEL_OVERRIDES.items()]
    path = tmp_path / "tiny_tree.yaml"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tree, its yaml, the port's float32 model with the reference's
    variables (non-trivial BN statistics), and the reference's jitted
    predict of one sample."""
    tmp = tmp_path_factory.mktemp("test_det")
    tree = cases.write_tree(tmp / "waymo", n_frames=2)
    path = write_cfg(tmp, tree)
    cfg = cfg_from_yaml_file(str(path), Config())
    model = common.build_detector(cfg, "cpu", dtype=torch.float32, seed=3)
    v = randomize_stats(to_flax(model.state_dict()), 7)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    jm = ref_common.build_detector(ref_cfg_from_yaml(str(path), RefConfig()),
                                   dtype=jnp.float32)
    kw = test_det.decode_kwargs(cfg)
    jitted = jax.jit(lambda v_, p, m: jm.predict(v_, p, m, **kw))
    return tmp, tree, path, model, lambda p, m: jitted(v, p, m)


def datasets(path, tta=False):
    """(reference dataset, port dataset) of the yaml at `path` in test
    mode."""
    out = []
    for load, cfg_cls, pkg in ((ref_cfg_from_yaml, RefConfig, ref_waymo),
                               (cfg_from_yaml_file, Config, waymo_dataset)):
        cfg = load(str(path), cfg_cls())
        if tta:
            cfg.update(TTA=True, TTA_CONFIG={"TTA_LIST": list(TTA_LIST)})
        out.append(pkg.WaymoDetectionDataset(cfg, cases.CLASS_NAMES,
                                             training=False))
    return out


def reference_inference(predict, ds, tta):
    """The reference's test_det loop (tools/test_det.py eval_one), one
    sample a predict call so that one compiled shape serves every batch."""
    annos = []
    batch_size = 1 if tta else 2
    for batch in ref_waymo.build_dataloader(ds, batch_size, shuffle=False,
                                            drop_last=False)(0):
        outs = [jax.tree.map(np.asarray, predict(
            batch["points"][i:i + 1], batch["points_valid"][i:i + 1]))
            for i in range(len(batch["points"]))]
        preds = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        dicts = ds.generate_prediction_dicts(batch, preds)
        if tta:
            names, boxes, scores = [], [], []
            for d, name in zip(dicts, batch["tta_name"]):
                boxes.append(ref_tta.invert_boxes(d["boxes_lidar"], name))
                names.append(d["name"])
                scores.append(d["score"])
            n, b, s = ref_wbf.wbf_online(
                np.concatenate(names), np.concatenate(boxes),
                np.concatenate(scores), class_names=tuple(cases.CLASS_NAMES),
                n_models=len(dicts))
            dicts = [{"name": n, "score": s, "boxes_lidar": b,
                      "frame_id": dicts[0]["frame_id"],
                      "sequence_name": dicts[0]["sequence_name"],
                      "pose": dicts[0]["pose"]}]
        annos.extend(dicts)
    return annos


@pytest.mark.parametrize("tta", [False, True])
def test_run_inference_matches_the_reference(setup, tta):
    _, _, path, model, predict = setup
    ref_ds, ds = datasets(path, tta)
    want = reference_inference(predict, ref_ds, tta)
    cfg = ds.cfg
    loader = waymo_dataset.build_dataloader(ds, 1 if tta else 2,
                                            shuffle=False, drop_last=False)
    before = waymo_dataset.NATIVE_SAMPLES
    timings = {}
    got = test_det.run_inference(model, ds, loader, cfg, timings=timings)
    assert waymo_dataset.NATIVE_SAMPLES - before == len(ds) == 2
    assert timings["frames"] == 2
    assert timings["samples"] == 2 * (1 + len(TTA_LIST) if tta else 1)
    assert len(got) == len(want) == 2
    kept = 0
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        assert (a["frame_id"], a["sequence_name"]) == \
            (b["frame_id"], b["sequence_name"])
        assert np.array_equal(a["pose"], b["pose"])
        assert np.array_equal(a["name"], b["name"])
        if not tta:
            assert np.array_equal(a["pred_labels"], b["pred_labels"])
        assert a["boxes_lidar"].shape == b["boxes_lidar"].shape
        assert np.abs(a["boxes_lidar"] - b["boxes_lidar"]).max() <= 1e-3
        assert np.abs(a["score"] - b["score"]).max() <= 1e-3
        kept += len(a["name"])
    assert kept > 2 * len(cases.CLASS_NAMES)

    # both packages' detections through the port's evaluation and the
    # reference's evaluator on the infos' GT, cut to 7 columns: the
    # reference's own evaluation raises on the tree's 9-wide GT (ROADMAP
    # queue 3)
    gts = [{"gt_boxes": info["annos"]["gt_boxes_lidar"][:, :7],
            "name": info["annos"]["name"], "num_points": np.zeros(0)}
           for info in ref_ds.infos]
    for annos in (want, got):
        for mode in ("envelope", "waymo101"):
            r_ref = ref_evaluator.evaluate_detection(
                annos, gts, class_names=tuple(cases.CLASS_NAMES),
                ap_mode=mode)
            table, res = ds.evaluation(annos, cases.CLASS_NAMES,
                                       ap_mode=mode)
            assert res == r_ref
            assert table == ref_evaluator.format_results_table(r_ref)
    with pytest.raises(ValueError, match="reshape"):
        ref_ds.evaluation(want, cases.CLASS_NAMES)


def test_cli_saves_what_the_reference_tracker_reads(setup, tmp_path,
                                                    monkeypatch):
    """main() restores the newest checkpoint of the experiment, predicts
    every frame, pickles the detections and evaluates them; the
    reference's run_track reads that pickle."""
    _, tree, path, model, _ = setup
    out = tmp_path / "out"
    exp = out / path.stem / "default"
    from detzero_tpu_torch.core.checkpoint import CheckpointManager
    CheckpointManager(exp / "ckpt").save(5, {"model": model.state_dict(),
                                             "step": 5})
    args = ["--cfg_file", str(path), "--device", "cpu", "--workers", "0",
            "--output_dir", str(out), "--save_to_file"]
    res = test_det.main(args)
    assert res["step"] == 5 and res["result_path"] == exp / "result.pkl"
    with open(res["result_path"], "rb") as f:
        saved = pickle.load(f)
    assert len(saved) == 2 and all(len(d["name"]) for d in saved)
    assert set(res["results"]) >= set(cases.CLASS_NAMES)
    assert "APH_L1" in res["table"]

    from tools import run_track as ref_run_track
    monkeypatch.setattr(sys, "argv", [
        "run_track", "--data_path", str(res["result_path"]), "--output_dir",
        str(tmp_path / "track"), "--workers", "1"])
    ref_run_track.main()
    tracks = list((tmp_path / "track").glob("tracking-val-*.pkl"))
    assert len(tracks) == 1
    with open(tracks[0], "rb") as f:
        assert list(pickle.load(f)) == ["segment-tiny_000"]

    # --eval_all evaluates each new checkpoint once, then stops waiting
    monkeypatch.setattr(test_det, "POLL_S", 0.01)
    evaluated = test_det.main(args + ["--eval_all", "--max_waiting_mins",
                                      "0.001", "--max_batches", "1"])
    assert [e["step"] for e in evaluated] == [5]
    assert len(evaluated[0]["det_annos"]) == 1      # one batch of 1 frame
    assert (exp / "result_5.pkl").exists()
    assert (exp / "eval_list.txt").read_text() == "5"
    assert test_det.main(args + ["--eval_all", "--max_waiting_mins",
                                 "0.001"]) == []


def test_cli_refusals(setup, tmp_path, monkeypatch):
    _, _, path, _, _ = setup
    args = ["--cfg_file", str(path), "--workers", "0", "--output_dir",
            str(tmp_path)]
    # --data_parallel without a process group is the single-process run
    # (tests/test_torch_dist_tools.py runs it on 2 ranks)
    res = test_det.main(args + ["--device", "cpu", "--data_parallel",
                                "--max_batches", "1"])
    assert res["timings"]["samples"] == 1 and len(res["det_annos"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_det.main(args)                     # --device cuda by default

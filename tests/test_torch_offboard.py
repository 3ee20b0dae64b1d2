"""The offboard pipeline of the port on the CPU against the reference, on
tests/test_offboard.py's scene (12 frames, a moving vehicle and a
pedestrian):

  * `OffboardPipeline.run_sequence`, track and combine only, and with
    GRM/PRM/CRM (D_MODEL 32, the reference's flax weights carried across
    by `convert_refiner`): final boxes and scores within 1e-4 of scale,
    obj ids and labels equal, the same timing keys; the artifact round
    trip;
  * the `combine_output` CLI's pickle, the `detzero_eval` tables (detection
    envelope and waymo101 with the range breakdown, on final frames and on
    a flat result list, and tracking), `run_offboard` with no refiners on
    the {points, poses} layout: equal to the reference CLIs';
  * `run_offboard` with a tiny GRM trained by the port's `train_refine`
    (--device cpu): its sizes equal `OffboardPipeline`'s with that model;
  * the submission .bin byte-equal to the reference's `write_submission`;
  * two faults of the reference, pinned: its run_offboard cannot read the
    preprocessed tree as points root (the port's shared loader can, with
    the infos' poses), and its submission writer raises on, or mixes up,
    9-wide boxes (the port takes their first 7 columns);
  * `StageTimer`'s report in the reference's format.
"""

import json
import logging
import pickle
import sys

import numpy as np
import pytest
import torch

from detzero_tpu.core.profiling import StageTimer as RefTimer
from detzero_tpu.pipeline import evaluator as ref_evaluator
from detzero_tpu.pipeline import submit as ref_submit
from detzero_tpu.pipeline.offboard import OffboardPipeline as RefPipeline
from detzero_tpu_torch.core import profiling
from detzero_tpu_torch.core.checkpoint import CheckpointManager
from detzero_tpu_torch.data import waymo_preprocess as wp
from detzero_tpu_torch.data.tfrecord_io import write_tfrecord
from detzero_tpu_torch.pipeline import daemon, evaluator, submit
from detzero_tpu_torch.pipeline.offboard import OffboardPipeline
from detzero_tpu_torch.protos import waymo_metrics_pb2 as mpb
from detzero_tpu_torch.tools import (
    combine_output, detzero_eval, prepare_object_data, run_offboard,
    train_refine,
)
from detzero_tpu_torch.tools.common import load_sequence_points
from tools import combine_output as ref_combine_output
from tools import detzero_eval as ref_detzero_eval
from tools import prepare_object_data as ref_prepare_object_data
from tools import run_offboard as ref_run_offboard

import test_waymo_tfrecord as tw
import torch_refine_cases as cases
from test_offboard import N_FRAMES, scene
from test_torch_refining import close, port_model, ref_model

torch.set_num_threads(1)
TRACK_CFG = {"TRACKING": {"SCORE_THRESH": 0.5}}
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
SAMPLERS = {"grm": {"query_num": cases.Q, "query_points": cases.NP,
                    "memory_points": cases.M},
            "prm": {"query_num": cases.T, "query_points": cases.NP,
                    "memory_points": cases.NM}}
SAMPLERS["crm"] = SAMPLERS["prm"]


def assert_frames_close(want, got, tol=1e-4):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert set(a) == set(b)
        assert np.array_equal(a["obj_ids"], b["obj_ids"])
        assert np.array_equal(a["labels"], b["labels"])
        for k in ("boxes", "scores"):
            assert close(a[k], b[k], tol), (k, a[k], b[k])


def assert_tree_equal(a, b, path=""):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def refiners():
    """(reference triples, port pairs) of GRM, PRM and CRM with the same
    perturbed weights."""
    ref, port = {}, {}
    for seed, kind in enumerate(("grm", "prm", "crm")):
        jm = ref_model(kind)
        v = cases.flax_variables(jm, kind, seed=seed)
        ref[kind] = (jm, {"params": v["params"]}, SAMPLERS[kind])
        port[kind] = (port_model(kind, v), SAMPLERS[kind])
    return ref, port


def test_track_and_combine_equal(scene):
    det_frames, frame_points, poses, gt_boxes = scene
    want = RefPipeline(TRACK_CFG).run_sequence(det_frames, frame_points,
                                               poses, gt_boxes=gt_boxes)
    got = OffboardPipeline(TRACK_CFG).run_sequence(
        det_frames, frame_points, poses, gt_boxes=gt_boxes)
    assert len(got["frames"]) == N_FRAMES
    assert sorted(got["tracks"]["tracks"]) == \
        sorted(want["tracks"]["tracks"]) == [0, 1]
    assert_frames_close(want["frames"], got["frames"])
    assert got["timings"].keys() == want["timings"].keys() == {
        "track", "prepare_objects", "refine", "combine"}
    assert all(v["calls"] == 1 for v in got["timings"].values())


def test_refiners_equal(scene, refiners):
    det_frames, frame_points, poses, gt_boxes = scene
    ref, port = refiners
    want = RefPipeline(TRACK_CFG, **ref).run_sequence(
        det_frames, frame_points, poses, gt_boxes=gt_boxes)
    pipe = OffboardPipeline(TRACK_CFG, **port)
    got = pipe.run_sequence(det_frames, frame_points, poses,
                            gt_boxes=gt_boxes)
    assert_frames_close(want["frames"], got["frames"])
    # the refiners moved the boxes: sizes differ from the detections'
    moved = np.abs(got["frames"][0]["boxes"][:, 3:6]
                   - det_frames[0]["boxes"][:, 3:6]).max()
    assert moved > 1e-3
    assert set(pipe._refiners) == {("grm", None), ("prm", None),
                                   ("crm", None)}


def test_artifact_roundtrip(tmp_path, scene):
    det_frames = scene[0]
    pipe = OffboardPipeline(TRACK_CFG)
    tr = pipe.track(det_frames)
    p = tmp_path / "sub" / "tracking.pkl"
    pipe.save_artifact(tr, p)
    assert_tree_equal(pipe.load_artifact(p), tr)


def run_ref_cli(monkeypatch, module, args):
    monkeypatch.setattr(sys, "argv", [module.__name__, *args])
    return module.main()


def test_combine_output_cli_equal(scene, tmp_path, monkeypatch):
    det_frames, frame_points, poses, gt_boxes = scene
    out = OffboardPipeline(TRACK_CFG).run_sequence(
        det_frames, frame_points, poses, gt_boxes=gt_boxes)
    rng = np.random.RandomState(4)
    geo, pos, conf = {}, {}, {}
    for seq in ("seq_a", "seq_b"):
        for oid, rec in out["objects"].items():
            cls = CLASSES[int(rec["label"])]
            path = tmp_path / "objects" / cls / f"{seq}.pkl"
            path.parent.mkdir(parents=True, exist_ok=True)
            recs = pickle.loads(path.read_bytes()) if path.exists() else {}
            recs[oid] = rec
            path.write_bytes(pickle.dumps(recs))
            t = len(rec["boxes_global"])
            geo.setdefault(seq, {})[oid] = {"size": rng.uniform(1, 4, 3)}
            pos.setdefault(seq, {})[oid] = {
                "centers": rec["boxes_global"][:, :3] + rng.randn(t, 3) * .1,
                "headings": rng.uniform(-np.pi, np.pi, t)}
            conf.setdefault(seq, {})[oid] = {"new_score": rng.rand(t)}
    drops = {"seq_a": out["tracks"]["drop"]}
    paths = {}
    for name, obj in (("geo", geo), ("pos", pos), ("conf", conf),
                      ("drop", drops)):
        paths[name] = tmp_path / f"{name}.pkl"
        paths[name].write_bytes(pickle.dumps(obj))
    args = ["--object_root", str(tmp_path / "objects"), "--geometry_path",
            str(paths["geo"]), "--position_path", str(paths["pos"]),
            "--confidence_path", str(paths["conf"]), "--combine_drop_path",
            str(paths["drop"])]
    run_ref_cli(monkeypatch, ref_combine_output,
                args + ["--output_path", str(tmp_path / "ref.pkl")])
    got = combine_output.main(args + ["--output_path",
                                      str(tmp_path / "port.pkl")])
    want = pickle.loads((tmp_path / "ref.pkl").read_bytes())
    assert_tree_equal(want, pickle.loads((tmp_path / "port.pkl")
                                         .read_bytes()))
    assert_tree_equal(want, got)
    assert sorted(got) == ["seq_a", "seq_b"] and len(got["seq_a"]) == \
        N_FRAMES


def eval_inputs(scene, tmp_path):
    """final_frames.pkl with its {seq: [GT]} pickle, a flat result list
    with its GT list, and tracking pickles on both sides."""
    det_frames, frame_points, poses, gt_boxes = scene
    out = OffboardPipeline(TRACK_CFG).run_sequence(
        det_frames, frame_points, poses, gt_boxes=gt_boxes)
    names = np.array(["Vehicle", "Pedestrian"])
    gt = [{"gt_boxes": g, "name": names, "num_points": np.array([80, 4])}
          for g in gt_boxes]
    flat_pred = [{"boxes_lidar": f["boxes"], "score": f["scores"],
                  "name": names[f["labels"]], "sequence_name": "seq0",
                  "frame_id": i} for i, f in enumerate(out["frames"])]
    flat_gt = [dict(g, sequence_name="seq0", frame_id=i)
               for i, g in enumerate(gt)]
    track_pred = {"seq0": [{"boxes": f["boxes"], "obj_ids": f["obj_ids"],
                            "name": names[f["labels"]]}
                           for f in out["frames"]]}
    track_gt = {"seq0": [{"boxes": g, "obj_ids": np.array([7, 8]),
                          "name": names} for g in gt_boxes]}
    files = {}
    for name, obj in (("final", {"seq0": out["frames"]}),
                      ("final_gt", {"seq0": gt}), ("flat", flat_pred),
                      ("flat_gt", flat_gt), ("track", track_pred),
                      ("track_gt", track_gt)):
        files[name] = tmp_path / f"{name}.pkl"
        files[name].write_bytes(pickle.dumps(obj))
    return files


@pytest.mark.parametrize("pred,gt,extra", [
    ("final", "final_gt", []),
    ("final", "final_gt", ["--ap_mode", "waymo101", "--range_breakdown"]),
    ("flat", "flat_gt", ["--range_breakdown"]),
    ("track", "track_gt", ["--metric", "tracking"])])
def test_detzero_eval_tables_equal(scene, tmp_path, monkeypatch, pred, gt,
                                   extra):
    files = eval_inputs(scene, tmp_path)
    tables = {}

    def capture(module, key):
        fmt = module.format_results_table

        def wrapped(res):
            tables[key] = fmt(res)
            return tables[key]
        monkeypatch.setattr(module, "format_results_table", wrapped)

    capture(ref_evaluator, "ref")
    capture(evaluator, "port")
    args = ["--pred_path", str(files[pred]), "--gt_path", str(files[gt]),
            *extra]
    run_ref_cli(monkeypatch, ref_detzero_eval, args)
    res = detzero_eval.main(args)
    assert tables["port"] == tables["ref"]
    assert "Vehicle" in tables["port"] and res["Vehicle"]
    if pred == "final" and not extra:
        # the tracker's boxes are the scene's (identity poses): AP high
        assert res["Vehicle"]["AP_L2"] > 0.9


def write_blob_tree(scene, root):
    det_frames, frame_points, poses, _ = scene
    root.mkdir(parents=True)
    (root / "seq0.pkl").write_bytes(pickle.dumps(
        {"points": frame_points, "poses": poses}))
    names = np.array(["Vehicle", "Pedestrian"])
    dets = [{"boxes_lidar": np.concatenate([f["boxes"], np.zeros((2, 2))],
                                           1),
             "score": f["scores"], "name": names[f["labels"]],
             "sequence_name": "seq0", "frame_id": i, "pose": f["pose"]}
            for i, f in enumerate(det_frames)]
    (root / "result.pkl").write_bytes(pickle.dumps(dets))
    return root / "result.pkl"


def test_run_offboard_no_refiners_equal(scene, tmp_path, monkeypatch):
    det = write_blob_tree(scene, tmp_path / "tree")
    gt = tmp_path / "gt.pkl"
    names = np.array(["Vehicle", "Pedestrian"])
    gt.write_bytes(pickle.dumps({"seq0": [
        {"gt_boxes": g, "name": names} for g in scene[3]]}))
    common = ["--det_path", str(det), "--points_root", str(tmp_path / "tree"),
              "--gt_path", str(gt), "--viewer_html"]
    tables = {}
    fmt = ref_evaluator.format_results_table
    monkeypatch.setattr(ref_evaluator, "format_results_table",
                        lambda r: tables.setdefault("ref", fmt(r)))
    run_ref_cli(monkeypatch, ref_run_offboard,
                common + ["--output_dir", str(tmp_path / "ref")])
    res = run_offboard.main(common + ["--output_dir", str(tmp_path / "port"),
                                      "--device", "cpu"])
    for name in ("final_frames.pkl", "tracking_seq0.pkl",
                 "objects_seq0.pkl"):
        assert_tree_equal(
            pickle.loads((tmp_path / "ref" / name).read_bytes()),
            pickle.loads((tmp_path / "port" / name).read_bytes()))
    assert res["final_path"] == tmp_path / "port" / "final_frames.pkl"
    assert_tree_equal(pickle.loads(res["final_path"].read_bytes()),
                      res["final_frames"])
    assert evaluator.format_results_table(res["results"]) == tables["ref"]
    assert (tmp_path / "port" / "seq0.html").read_text() == \
        (tmp_path / "ref" / "seq0.html").read_text()
    assert set(res["timings"]) == {"track", "prepare_objects", "refine",
                                   "combine"}
    assert "mean_ms" in res["report"]


def test_run_offboard_with_a_trained_grm(scene, tmp_path):
    det_frames, frame_points, poses, gt_boxes = scene
    det = write_blob_tree(scene, tmp_path / "tree")
    tr = OffboardPipeline(TRACK_CFG).track(det_frames)
    recs = daemon.prepare_object_data(tr, frame_points, poses,
                                      gt_boxes=gt_boxes)
    (tmp_path / "records" / "Vehicle").mkdir(parents=True)
    (tmp_path / "records" / "Vehicle" / "seq0.pkl").write_bytes(
        pickle.dumps({k: r for k, r in recs.items() if r["label"] == 0}))
    yaml = tmp_path / "tiny_grm.yaml"
    cfg = {"CLASS_NAME": "Vehicle", "DATASET": "WaymoGeometryDataset",
           "DATA_PATH": str(tmp_path / "records"), "QUERY_NUM": cases.Q,
           "QUERY_POINTS": cases.NP, "MEMORY_POINTS": cases.M,
           "POINT_FEATURES": 11, "MODEL": cases.ref_cfg("grm")["MODEL"],
           "OPTIMIZATION": dict(cases.OPT, BATCH_SIZE_PER_DEVICE=1)}
    yaml.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in cfg.items()))
    trainer = train_refine.main(["--cfg_file", str(yaml), "--device", "cpu",
                                 "--workers", "0", "--output_dir",
                                 str(tmp_path / "out"), "--max_steps", "2"])
    ckpt = tmp_path / "out" / "tiny_grm" / "default" / "ckpt"
    assert trainer.step_count == 2 and CheckpointManager(ckpt).latest_step() \
        == 2
    res = run_offboard.main([
        "--det_path", str(det), "--points_root", str(tmp_path / "tree"),
        "--output_dir", str(tmp_path / "port"), "--device", "cpu",
        "--track_cfg", "configs/tk_model_cfgs/waymo_detzero_track.yaml",
        "--grm_cfg", str(yaml), "--grm_ckpt", str(ckpt),
        "--set", "MODEL.TRACKING.SCORE_THRESH", "0.5"])
    model, sampler = run_offboard.load_refiner(yaml, ckpt, "cpu")
    assert sampler == SAMPLERS["grm"]
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), trainer.model.state_dict().values()))
    from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
    track = cfg_from_yaml_file(
        "configs/tk_model_cfgs/waymo_detzero_track.yaml", Config())["MODEL"]
    track["TRACKING"]["SCORE_THRESH"] = 0.5
    want = OffboardPipeline(track, grm=(model, sampler)).run_sequence(
        det_frames, frame_points, poses)["frames"]
    got = res["final_frames"]["seq0"]
    assert_frames_close(want, got, tol=0)
    sizes = np.concatenate([f["boxes"][:, 3:6] for f in got])
    assert len(sizes) and not np.allclose(
        sizes, np.concatenate([f["boxes"][:, 3:6] for f in det_frames]))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_offboard.load_refiner(yaml, tmp_path / "none", "cpu")


def test_submission_bytes_equal(tmp_path):
    rng = np.random.RandomState(0)
    preds, meta = [], []
    for f in range(4):
        n = [0, 1, 5, 12][f]
        preds.append({"boxes_lidar": rng.randn(n, 7), "score": rng.rand(n),
                      "name": np.array(CLASSES + ["Sign", "Other"])[
                          rng.randint(5, size=n)],
                      "obj_ids": rng.randint(1000, size=n)})
        meta.append({"context_name": f"ctx_{f // 2}",
                     "frame_timestamp_micros": 1_000_000 + 100_000 * f})
    for tracking in (False, True):
        recs = submit.build_submission_records(preds, meta, tracking)
        assert recs == ref_submit.build_submission_records(preds, meta,
                                                           tracking)
        want = ref_submit.write_submission(recs, tmp_path / "ref.bin",
                                           tracking=tracking)
        got = submit.write_submission(recs, tmp_path / "port.bin",
                                      tracking=tracking)
        assert want.suffix == got.suffix == ".bin"
        assert got.read_bytes() == want.read_bytes()
        objs = mpb.Objects()
        objs.ParseFromString(got.read_bytes())
        assert len(objs.objects) == len(recs) == 18
        assert [o.object.id for o in objs.objects] == \
            [str(i) if tracking else "" for p in preds for i in p["obj_ids"]]


def test_fault_submission_of_9_wide_boxes():
    """The reference reshapes boxes to (-1, 7): 3 boxes of 9 raise, 7 of 9
    give 9 boxes of mixed columns; the port takes each box's first 7."""
    meta = [{"context_name": "c", "frame_timestamp_micros": 1}]
    for n in (3, 7):
        boxes = np.random.RandomState(n).randn(n, 9)
        pred = {"boxes_lidar": boxes, "score": np.ones(n),
                "name": np.array(["Vehicle"] * n)}
        if n == 3:
            with pytest.raises(ValueError, match="reshape"):
                ref_submit.build_submission_records([pred], meta)
        else:
            wrong = ref_submit.build_submission_records(
                [dict(pred, score=np.ones(9), name=np.array(["Vehicle"] * 9))],
                meta)
            assert len(wrong) == 9 and wrong[1]["box"]["center_x"] == \
                boxes[0, 7]
        recs = submit.build_submission_records([pred], meta)
        assert len(recs) == n
        assert [list(r["box"].values()) for r in recs] == \
            boxes[:, :7].tolist()


def test_fault_points_root_is_the_preprocessed_tree(tmp_path, monkeypatch):
    """The reference's run_offboard and prepare_object_data read `<seq>.pkl` as a {points, poses} blob,
    but preprocessing writes the info list there; the port's loader reads
    the tree with the infos' poses (run_offboard and prepare_object_data
    take it), and refuses a bare <seq>/."""
    frames = [tw._make_frame(s, timestamp=1000 + 100 * s)[0]
              for s in range(3)]
    raw = tmp_path / "segment-0001.tfrecord"
    write_tfrecord(raw, [f.SerializeToString() for f in frames])
    infos = wp.process_single_sequence(raw, tmp_path / "processed")
    logger = logging.getLogger("test")
    with pytest.raises(TypeError):
        ref_run_offboard._load_points(tmp_path / "processed",
                                      "segment-0001", 3, logger)
    dets = [{"boxes": i["annos"]["gt_boxes_lidar"], "scores": np.ones(2),
             "labels": np.array([0, 1]), "pose": i["pose"]} for i in infos]
    tr = OffboardPipeline({"POST_PROCESSING": {"LEAST_AGE": 1}}).track(dets)
    assert len(tr["tracks"]) >= 2
    (tmp_path / "tracking.pkl").write_bytes(pickle.dumps(
        {"segment-0001": tr}))
    args = ["--track_path", str(tmp_path / "tracking.pkl"), "--points_root",
            str(tmp_path / "processed")]
    with pytest.raises(TypeError):
        run_ref_cli(monkeypatch, ref_prepare_object_data,
                    args + ["--output_dir", str(tmp_path / "ref")])
    written = prepare_object_data.main(args + ["--output_dir",
                                               str(tmp_path / "port")])
    pts, poses = load_sequence_points(tmp_path / "processed", "segment-0001")
    recs = daemon.prepare_object_data(tr, pts, poses)
    got = pickle.loads(written["Vehicle"]["segment-0001"].read_bytes())
    assert sorted(got) == sorted(k for k, t in tr["tracks"].items()
                                 if t["label"] == 0)
    for oid, rec in got.items():
        for a, b in zip(rec["pts"], recs[oid]["pts"]):
            assert np.array_equal(a, b)
    assert len(pts) == len(poses) == 3
    for i, info in enumerate(infos):
        assert poses[i] is not None and np.array_equal(poses[i],
                                                       info["pose"])
        assert np.array_equal(pts[i], np.load(
            tmp_path / "processed" / "segment-0001" / f"{i:04d}.npy"))
    assert poses[2][0, 3] == 4.0            # _make_frame's ego at 2 m a seed
    (tmp_path / "processed" / "segment-0001.pkl").unlink()
    with pytest.raises(FileNotFoundError, match="poses"):
        load_sequence_points(tmp_path / "processed", "segment-0001")
    with pytest.raises(FileNotFoundError, match="poses"):
        prepare_object_data.main(args + ["--output_dir",
                                         str(tmp_path / "port2")])
    assert load_sequence_points(tmp_path / "processed", "missing") is None


def test_stage_timer_report_format(tmp_path):
    ref, port = RefTimer(), profiling.StageTimer()
    for t in (ref, port):
        t.add("track", 1.25)
        t.add("prepare_objects", 0.5)
        t.add("track", 0.75)
        t.add("refine", 0.0)
    assert port.report() == ref.report()
    assert port.as_dict() == ref.as_dict()
    assert profiling.StageTimer().report() == RefTimer().report()
    x = torch.ones(4)
    assert port.block("wait", {"a": [x]})["a"][0] is x
    with pytest.raises(ValueError):
        with port("fails"):
            raise ValueError
    assert port.as_dict()["fails"]["calls"] == 1
    with profiling.trace(tmp_path / "trace"):
        with profiling.span("step", "step_num", 0):
            (x * 2).sum()
    assert "step step_num=0" in (tmp_path / "trace" / "trace.json") \
        .read_text()
    with profiling.trace(None):
        pass

"""The port's offline tracker (detzero_tpu_torch.models.tracking) and its
CLIs (tools/run_track.py, tools/eval_track.py) against the reference's on
the CPU, bit for bit: DetZeroTracker's tracks and drop data on the scenes
of tests/test_tracker_parity.py and tests/test_tracking.py under both
motion filters (configs/tk_model_cfgs/waymo_detzero_track.yaml,
waymo_ab3dmot.yaml); TrackManager's forward pass against the reference's
oracle; the track assignment and recall of eval_track exactly; and
run_track then eval_track in-process on one result.pkl
through both packages (the same pickles and metrics), the port's worker
pool started with "spawn"."""

import pickle
import sys

import numpy as np
import pytest

from detzero_tpu.core.config import Config as RefConfig
from detzero_tpu.core.config import cfg_from_yaml_file as ref_cfg_from_yaml
from detzero_tpu.models.tracking import DetZeroTracker as RefTracker
from detzero_tpu.models.tracking import target_assign as ref_target_assign
from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
from detzero_tpu_torch.core.registry import MOTION_FILTERS
from detzero_tpu_torch.models.tracking import DetZeroTracker, TrackManager
from detzero_tpu_torch.models.tracking import target_assign
from detzero_tpu_torch.models.tracking.kalman import CenterKalmanFilter
from detzero_tpu_torch.tools import eval_track, run_track

import test_tracker_parity as parity
import test_tracking

CFGS = ("configs/tk_model_cfgs/waymo_detzero_track.yaml",
        "configs/tk_model_cfgs/waymo_ab3dmot.yaml")


def assert_same(a, b, where=""):
    """Equal values of equal types, through dicts, lists and arrays."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def scenes():
    """Every scene of the reference's tracker tests, with poses that move
    the ego (so the drop data's transform is exercised) where none is
    given."""
    out = {f.__name__: f() for f in (
        parity._scene_slow_vehicle_with_gap, parity._scene_weak_stage2,
        parity._scene_two_vehicles, parity._scene_weak_frame0)}
    out["two_objects"] = test_tracking.make_sequence()
    out["missed"] = test_tracking.make_sequence(drop_frames=(8, 9))
    head = test_tracking.make_sequence(drop_frames=(0,))
    for f in (1, 2):
        head[f]["scores"][0] = 0.2
    out["weak_head"] = head
    rng = np.random.RandomState(9)
    for name, seq in out.items():
        for f, fr in enumerate(seq):
            if "pose" not in fr:
                pose = np.eye(4, dtype=np.float32)
                pose[:2, 3] = [0.5 * f, 0.1 * f]
                fr["pose"] = pose
            if len(fr["boxes"]) and name == "two_objects":
                # a near-duplicate of the first box: the overlap filter's
                # drop data
                dup = fr["boxes"][:1] + rng.randn(1, 7).astype(
                    np.float32) * 0.02
                fr["boxes"] = np.concatenate([fr["boxes"], dup])
                fr["scores"] = np.concatenate([fr["scores"], [0.3]])
                fr["labels"] = np.concatenate([fr["labels"], [0]])
    return out


@pytest.mark.parametrize("cfg_file", CFGS)
def test_tracker_bit_for_bit(cfg_file):
    ref_cfg = ref_cfg_from_yaml(cfg_file, RefConfig())["MODEL"]
    cfg = cfg_from_yaml_file(cfg_file, Config())["MODEL"]
    assert ref_cfg == cfg
    n_tracks = n_drops = 0
    for name, seq in scenes().items():
        want = RefTracker(ref_cfg)(seq)
        got = DetZeroTracker(cfg)(seq)
        assert_same(want, got, name)
        n_tracks += len(got["tracks"])
        n_drops += sum(len(d["boxes"]) for d in got["drop"])
    assert n_tracks >= 10 and n_drops > 0


@pytest.mark.parametrize("scene", [
    parity._scene_slow_vehicle_with_gap, parity._scene_weak_stage2,
    parity._scene_two_vehicles, parity._scene_weak_frame0])
def test_forward_matches_reference_oracle(scene):
    """tests/test_tracker_parity.py's oracle of the reference's forward
    semantics, on the port's TrackManager."""
    seq = scene()
    got, _ = TrackManager({"SCORE_THRESH": 0.5, "MIN_POINTS": 0,
                           "MAX_AGE": -1, "REVERSE": False,
                           "TIGHT_THRESH": [0.2], "LOOSE_THRESH": [0.3]}
                          ).forward(seq)
    want = parity._oracle_forward(seq)
    assert len(got) == len(want)
    got = sorted(got, key=lambda t: (t.birth_frame, t.boxes[0][0]))
    want = sorted(want, key=lambda t: (t["frames"][0], t["boxes"][0][0]))
    for g, w in zip(got, want):
        assert g.frames == w["frames"] and g.hits == w["hits"]
        np.testing.assert_allclose(g.scores, w["scores"], atol=1e-9)
        np.testing.assert_allclose(np.stack(g.boxes), np.stack(w["boxes"]),
                                   atol=1e-9)


def test_filters_registered():
    assert {"CenterKalmanFilter", "AB3DMOTFilter"} <= set(
        MOTION_FILTERS.keys())
    assert MOTION_FILTERS.get("CenterKalmanFilter") is CenterKalmanFilter


def result_and_gt(n_seq=2, n_frames=16, seed=4):
    """A detection result.pkl's frames (two sequences of three classes'
    objects moving at constant velocity, with noise, misses and false
    positives) and its GT in eval_track's layout."""
    rng = np.random.RandomState(seed)
    names = np.array(["Vehicle", "Pedestrian", "Cyclist"] * 2)
    sizes = {"Vehicle": [4.5, 2.0, 1.6], "Pedestrian": [0.9, 0.9, 1.7],
             "Cyclist": [1.8, 0.8, 1.7]}
    dets, gt = [], {}
    for s in range(n_seq):
        seq = f"segment-{s:03d}"
        start = rng.uniform(-30, 30, (6, 2))
        vel = rng.uniform(-0.8, 0.8, (6, 2))
        gt[seq] = []
        for f in range(n_frames):
            boxes = np.zeros((6, 7), np.float32)
            boxes[:, :2] = start + vel * f
            boxes[:, 3:6] = [sizes[n] for n in names]
            boxes[:, 6] = np.arctan2(vel[:, 1], vel[:, 0])
            gt[seq].append({"boxes": boxes.astype(float),
                            "obj_ids": np.arange(6)})
            keep = rng.rand(6) > 0.1
            det = boxes[keep] + np.c_[rng.randn(keep.sum(), 2) * 0.05,
                                      np.zeros((keep.sum(), 5))]
            fp = np.array([[*rng.uniform(-30, 30, 2), 0, 4.5, 2.0, 1.6, 0]])
            dets.append({
                "name": np.concatenate([names[keep], ["Vehicle"]]),
                "score": np.concatenate([rng.uniform(0.4, 1, keep.sum()),
                                         [0.15]]).astype(np.float32),
                "boxes_lidar": np.concatenate([det, fp]).astype(np.float32),
                "frame_id": f, "sequence_name": seq,
                "pose": np.eye(4, dtype=np.float32)})
    return dets, gt


def test_run_and_eval_track_through_both_packages(tmp_path, monkeypatch):
    dets, gt = result_and_gt()
    data = tmp_path / "result.pkl"
    data.write_bytes(pickle.dumps(dets))
    gt_path = tmp_path / "gt.pkl"
    gt_path.write_bytes(pickle.dumps(gt))

    from tools import eval_track as ref_eval_track
    from tools import run_track as ref_run_track
    monkeypatch.setattr(sys, "argv", [
        "run_track", "--data_path", str(data), "--output_dir",
        str(tmp_path / "ref"), "--workers", "1"])
    ref_run_track.main()
    got = run_track.main(["--data_path", str(data), "--output_dir",
                          str(tmp_path / "port"), "--workers", "1"])
    pickles = {}
    for pkg in ("ref", "port"):
        for kind in ("tracking", "drop"):
            (path,) = (tmp_path / pkg).glob(f"{kind}-val-*.pkl")
            pickles[pkg, kind] = pickle.loads(path.read_bytes())
    assert got["track_path"].parent == tmp_path / "port"
    for kind in ("tracking", "drop"):
        assert_same(pickles["ref", kind], pickles["port", kind], kind)
    assert list(pickles["port", "tracking"]) == ["segment-000",
                                                 "segment-001"]
    assert sum(len(v["tracks"]) for v in got["tracks"].values()) >= 12

    # eval_track: the reference logs its means, the port returns them too
    logged = {}

    class Log:
        def __init__(self, key):
            self.key = key

        def info(self, msg):
            logged.setdefault(self.key, []).append(msg)

    monkeypatch.setattr("detzero_tpu.core.logger.create_logger",
                        lambda *a, **k: Log("ref"))
    monkeypatch.setattr("detzero_tpu_torch.core.logger.create_logger",
                        lambda *a, **k: Log("port"))
    (ref_tracks,) = (tmp_path / "ref").glob("tracking-val-*.pkl")
    monkeypatch.setattr(sys, "argv", ["eval_track", "--track_path",
                                      str(ref_tracks), "--gt_path",
                                      str(gt_path)])
    ref_eval_track.main()
    metrics = eval_track.main(["--track_path", str(got["track_path"]),
                               "--gt_path", str(gt_path)])
    assert logged["ref"] == logged["port"] and len(logged["ref"]) == 4
    assert set(metrics) == {"recall", "precision", "MOTA", "MOTP"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["recall"] > 0.5 and metrics["MOTA"] > 0


def test_target_assignment_and_recall_exact():
    """The port's assign_track_target clips only the box pairs whose BEV
    circles meet; its assignment and recall equal the reference's, which
    clips every pair, on tracked sequences and on boxes that touch, nearly
    touch or overlap by a sliver."""
    dets, gt = result_and_gt(n_frames=8)
    cfg = cfg_from_yaml_file(CFGS[0], Config())
    seqs = run_track.group_by_sequence(dets, list(cfg["CLASS_NAMES"]))
    tracked = run_track.track_sequences(cfg["MODEL"], seqs, workers=1)
    base = np.array([0, 0, 0, 4.0, 2.0, 1.6, 0.3])
    edge = {"t0": {"boxes_global": np.stack([
        base + [dx, 0, 0, 0, 0, 0, 0] for dx in
        (4.0, 4.0 + 1e-9, 3.999, 4.47, 4.48)]), "sample_idx": np.arange(5)}}
    edge_gt = [{"boxes": base[None], "obj_ids": np.array([0])}
               for _ in range(5)]
    cases = [(tracked[k]["tracks"], gt[k]) for k in gt] + [(edge, edge_gt)]
    for tracks, frames in cases:
        for thresh in (0.0, 0.3):
            assert_same(
                ref_target_assign.assign_track_target(tracks, frames, thresh),
                target_assign.assign_track_target(tracks, frames, thresh))
        assert_same(ref_target_assign.track_recall(tracks, frames),
                    target_assign.track_recall(tracks, frames))


def test_spawned_pool_equals_in_process():
    """Two sequences over two spawned workers: the tracker outputs of the
    in-process run."""
    dets, _ = result_and_gt(n_frames=6)
    cfg = cfg_from_yaml_file(CFGS[0], Config())
    seqs = run_track.group_by_sequence(dets, list(cfg["CLASS_NAMES"]))
    pooled = run_track.track_sequences(cfg["MODEL"], seqs, workers=2)
    assert_same(run_track.track_sequences(cfg["MODEL"], seqs, workers=1),
                pooled)

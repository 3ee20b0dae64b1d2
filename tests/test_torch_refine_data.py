"""The refining stage's host data path of the port against the reference,
bit for bit on the CPU: the point features and samplers
(data/refine_features.py), the three refine datasets in train and eval
modes (data/refine_dataset.py; the reference's `ds.rng`, which its sampler
shares, replaced by the RandomState the port is given), the DZRC0001
record cache read across packages (data/record_cache.py and
tools/build_record_cache.py), and the daemon (pipeline/daemon.py:
prepare_object_data through the native cropper and the NumPy route,
generate_iou_gt, combine_output); and 3 steps of the port's Trainer
against the reference's on the datasets' collated batches: parameters
within 1e-4, but those whose gradient is rounding noise in every step (the
attention's key biases and the memory embedding's output bias move every
logit of a softmax row alike, so they have no effect, and Adam scales
their noise to +-lr): those are held to a gradient below 1e-6, and the
outputs after the steps within 1e-4 * max(|ref|, 1)."""

import copy
import pickle

import numpy as np
import pytest

import jax
import torch

from detzero_tpu.core.config import Config as RefConfig
from detzero_tpu.core.mesh import make_mesh
from detzero_tpu.core.optim import build_optimizer as ref_build_optimizer
from detzero_tpu.data import record_cache as ref_cache
from detzero_tpu.data import refine_dataset as ref_ds
from detzero_tpu.data import refine_features as ref_rf
from detzero_tpu.parallel.trainer import Trainer as RefTrainer
from detzero_tpu.pipeline import daemon as ref_daemon
from detzero_tpu_torch.convert import to_flax
from detzero_tpu_torch.core.optim import build_optimizer
from detzero_tpu_torch.core.registry import DATASETS
from detzero_tpu_torch.data import record_cache, refine_dataset
from detzero_tpu_torch.data import refine_features as rf
from detzero_tpu_torch.pipeline import daemon
from detzero_tpu_torch.parallel.trainer import Trainer
from detzero_tpu_torch.tools import build_record_cache
from tools.train_refine import make_loss_fn

import torch_refine_cases as cases
from test_torch_refining import (
    close, port_forward, port_model, ref_forward, ref_model,
)

torch.set_num_threads(1)

DS_CFG = {
    "WaymoGeometryDataset": {"QUERY_NUM": 3, "QUERY_POINTS": 16,
                             "MEMORY_POINTS": 64, "CYCLIST_REPEAT": 2},
    "WaymoPositionDataset": {"QUERY_NUM": 12, "QUERY_POINTS": 16,
                             "MEMORY_POINTS": 4, "CYCLIST_REPEAT": 2},
    "WaymoConfidenceDataset": {"QUERY_NUM": 12, "QUERY_POINTS": 16,
                               "CYCLIST_REPEAT": 2},
}


def assert_same(a, b, where=""):
    """Equal structure and equal values, arrays bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def test_point_features_and_samplers():
    recs = cases.object_records(0)
    rec = recs[0]
    for seed, training in ((1, True), (2, False)):
        for ref_cls, cls, kw in ((ref_rf.GRMSample, rf.GRMSample,
                                  dict(query_num=3, query_points=16,
                                       memory_points=64)),
                                 (ref_rf.PRMSample, rf.PRMSample,
                                  dict(query_num=12, query_points=16,
                                       memory_points=4))):
            want = ref_cls(training=training, rng=np.random.RandomState(
                seed), **kw)(rec)
            got = cls(training=training, rng=np.random.RandomState(seed),
                      **kw)(rec)
            assert_same(want, got, ref_cls.__name__)
    box = rec["boxes_global"][3]
    pts = rec["pts"][3]
    for fn in ("grm_point_features", "prm_point_features"):
        assert_same(getattr(ref_rf, fn)(pts, box, 0.7, 32,
                                        np.random.RandomState(4)),
                    getattr(rf, fn)(pts, box, 0.7, 32,
                                    np.random.RandomState(4)), fn)
    assert_same(ref_rf.sample_points(np.zeros((0, 4)), 5,
                                     np.random.RandomState(0)),
                rf.sample_points(np.zeros((0, 4)), 5,
                                 np.random.RandomState(0)))
    for training in (True, False):
        assert_same(ref_rf._select_track_frames(
            8, rec["matched"], training, np.random.RandomState(5)),
            rf._select_track_frames(8, rec["matched"], training,
                                    np.random.RandomState(5)))
    local = rf.boxes_to_init_coords(rec["boxes_global"],
                                    rec["boxes_global"][4])
    assert_same(ref_rf.boxes_to_init_coords(rec["boxes_global"],
                                            rec["boxes_global"][4]), local)
    assert_same(ref_rf.boxes_from_init_coords(local, rec["boxes_global"][4]),
                rf.boxes_from_init_coords(local, rec["boxes_global"][4]))
    assert_same(ref_rf.revert_prm_to_world(local[:, :3], local[:, 6],
                                           rec["boxes_global"][4]),
                rf.revert_prm_to_world(local[:, :3], local[:, 6],
                                       rec["boxes_global"][4]))
    assert_same(ref_rf.pad_track(list(local), 12), rf.pad_track(list(local),
                                                                12))
    with pytest.raises(TypeError):            # no fallback to np.random
        rf.GRMSample()


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("cls", ["Vehicle", "Cyclist"])
@pytest.mark.parametrize("name", sorted(DS_CFG))
def test_dataset_samples_bit_for_bit(name, cls, training):
    records = list(cases.object_records(7).values())
    cfg = DS_CFG[name]
    ref = getattr(ref_ds, name)(cfg, cls, training,
                                records=copy.deepcopy(records))
    r = np.random.RandomState(11)
    ref.rng = r
    ref.sampler.rng = r
    got = DATASETS.get(name)(cfg, cls, training, records=records,
                             rng=np.random.RandomState(11))
    assert len(ref) == len(got)
    if training:
        # GRM/PRM keep the matched tracks (4 of 6); CRM alternates them
        # with the negatives; Cyclist repeats CYCLIST_REPEAT times
        n = 4 * (2 if name == "WaymoConfidenceDataset" else 1)
        assert len(got) == n * (2 if cls == "Cyclist" else 1)
    for i in range(len(got)):
        assert_same(ref[i], got[i], f"{name}[{i}]")
    batch = got.collate_batch([got[0], got[1]])
    assert all(v.shape[0] == 2 for v in batch.values())


def test_dataset_targets_keep_the_reference_semantics():
    """PRM's center targets are residuals to the query boxes and its
    heading targets absolute (constant GT heading 0.3 minus the init box's
    heading, whatever the detector's pi-flips); CRM gathers its labels by
    frame."""
    records = list(cases.object_records(3).values())
    ds = refine_dataset.WaymoPositionDataset(
        dict(DS_CFG["WaymoPositionDataset"], AUGMENT=False), "Vehicle",
        True, records=records, rng=np.random.RandomState(0))
    s = ds[0]
    m = s["pad_mask"]
    rec = ds.records[0]
    assert np.asarray(rec["matched"])[s["frame_idx"][m]].all()
    h = 0.3 - s["init_box"][6]
    np.testing.assert_allclose(s["gt_headings"][m],
                               np.arctan2(np.sin(h), np.cos(h)), atol=1e-5)
    gt = rf.boxes_to_init_coords(
        np.asarray(rec["gt_boxes"])[s["frame_idx"]], s["init_box"])
    np.testing.assert_array_equal(s["gt_centers"][m], (
        gt[:, :3] - s["local_boxes"][:, :3])[m])
    crm = refine_dataset.WaymoConfidenceDataset(
        DS_CFG["WaymoConfidenceDataset"], "Vehicle", False,
        records=records)
    c = crm[2]
    np.testing.assert_array_equal(
        c["gt_ious"][c["pad_mask"]], records[2]["iou_gt"][:8])
    assert (c["gt_ious"][~c["pad_mask"]] == -1).all()


def test_record_cache_across_packages(tmp_path):
    recs = {f"obj{k}": v for k, v in cases.object_records(2, n=3).items()}
    recs["obj0"]["pts"][1] = np.zeros((0, 4), np.float32)
    for writer, reader in ((record_cache, ref_cache),
                           (ref_cache, record_cache)):
        path = tmp_path / f"{writer.__name__.split('.')[0]}.dzrc"
        writer.write_record_cache(path, recs)
        got = reader.RecordCache(path)
        assert got.keys == list(recs)
        for k, rec in recs.items():
            back = got[k]
            for field, v in rec.items():
                if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
                    assert_same(v, [np.asarray(p) for p in back[field]])
                elif isinstance(v, np.ndarray):
                    assert_same(v, np.asarray(back[field]))
                else:
                    assert back[field] == v
    assert path.read_bytes() == (tmp_path / "detzero_tpu_torch.dzrc") \
        .read_bytes()
    view = record_cache.RecordListView([record_cache.RecordCache(path)]) * 2
    assert len(view) == 6 and view[3]["_key"] == (path.stem, "obj0")


def test_dataset_reads_the_daemon_tree_and_caches(tmp_path):
    """Pickles in DATA_PATH/<Class>/ and the caches build_record_cache
    makes of them give the same samples, equal to the reference's on the
    same tree."""
    recs = cases.object_records(4)
    (tmp_path / "Vehicle").mkdir()
    with open(tmp_path / "Vehicle" / "seq0.pkl", "wb") as f:
        pickle.dump(recs, f)
    cfg = dict(DS_CFG["WaymoGeometryDataset"], DATA_PATH=str(tmp_path))
    from_pkl = refine_dataset.WaymoGeometryDataset(cfg, "Vehicle", False)
    assert build_record_cache.main(["--object_root", str(tmp_path),
                                    "--classes", "Vehicle",
                                    "--delete_pickles"]) == {"Vehicle": 6}
    assert not (tmp_path / "Vehicle" / "seq0.pkl").exists()
    from_cache = refine_dataset.WaymoGeometryDataset(cfg, "Vehicle", False)
    ref = ref_ds.WaymoGeometryDataset(cfg, "Vehicle", False)
    assert isinstance(from_cache.records, record_cache.RecordListView)
    assert len(from_pkl) == len(from_cache) == len(ref) == 6
    for i in range(6):
        assert from_cache.records[i]["_key"] == ("seq0", str(i))
        got = from_cache[i]
        assert_same(from_pkl[i], got)
        assert_same(ref[i], got)


def scene(seed=0, n_frames=5, n_obj=4):
    """A track result with 9-wide global boxes, per-frame LIDAR points
    (6 columns, NLZ -1 in the last but a few), non-identity poses, and the
    GT of every frame in the LIDAR's global frame."""
    rng = np.random.RandomState(seed)
    poses, frames, gts = [], [], []
    c0 = rng.uniform(-15, 15, (n_obj, 2))
    for f in range(n_frames):
        pose = np.eye(4)
        yaw = 0.05 * f
        pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                        [np.sin(yaw), np.cos(yaw)]]
        pose[:3, 3] = [2.0 * f, 0.5 * f, 0.1]
        poses.append(pose.astype(np.float32))
        g = np.zeros((n_obj, 7))
        g[:, :2] = c0 + [1.0 * f, 0]
        g[:, 3:6] = [4.4, 2.0, 1.6]
        g[:, 6] = 0.2
        gts.append(g)
        inv = np.linalg.inv(pose)
        pts = []
        for b in g:
            local = rng.uniform(-0.5, 0.5, (60, 3)) * b[3:6]
            pts.append(local + b[:3])
        pts.append(rng.uniform(-30, 30, (400, 3)))
        xyz = np.concatenate(pts)
        lidar = np.zeros((len(xyz), 6), np.float32)
        lidar[:, :3] = xyz @ inv[:3, :3].T + inv[:3, 3]
        lidar[:, 3] = rng.rand(len(xyz)) * 3
        lidar[:, 5] = np.where(rng.rand(len(xyz)) < 0.05, 1, -1)
        frames.append(lidar)
    tracks = {}
    for i in range(n_obj):
        boxes = np.zeros((n_frames, 9), np.float32)
        boxes[:, :7] = [g[i] for g in gts]
        boxes[:, :2] += rng.randn(n_frames, 2) * 0.1
        boxes[:, 7:9] = [10.0, 0.0]
        tracks[10 + i] = {"boxes_global": boxes,
                          "score": rng.rand(n_frames).astype(np.float32),
                          "sample_idx": np.arange(n_frames),
                          "hit": np.ones(n_frames, np.int32),
                          "state": "dynamic", "label": i % 3}
    # one track seen in frames 1 and 3 only, far from any GT
    tracks[99] = {"boxes_global": np.array([[40, 40, 0, 2, 2, 2, 0, 0, 0]] * 2,
                                           np.float32),
                  "score": np.float32([0.4, 0.5]), "sample_idx": np.array(
                      [1, 3]), "hit": np.array([1, 0], np.int32),
                  "label": 0}
    return {"tracks": tracks}, frames, poses, gts


def test_daemon_equal_to_the_reference(monkeypatch):
    from detzero_tpu_torch import native

    tr, frames, poses, gts = scene()
    ids = [np.arange(len(g)) for g in gts]
    want = ref_daemon.prepare_object_data(tr, frames, poses, nlz_col=5,
                                          gt_boxes=gts, gt_ids=ids)
    native0, numpy0 = daemon.NATIVE_FRAMES, daemon.NUMPY_FRAMES
    got = daemon.prepare_object_data(tr, frames, poses, nlz_col=5,
                                     gt_boxes=gts, gt_ids=ids)
    assert (daemon.NATIVE_FRAMES - native0, daemon.NUMPY_FRAMES - numpy0) \
        == (5, 0)
    assert_same(want, got)
    assert sum(len(p) for p in got[10]["pts"]) > 200
    assert got[10]["matched"].all() and not got[99]["matched"].any()
    # a machine where g++ builds nothing takes the reference's numpy route
    monkeypatch.setattr(native, "available", lambda: False)
    slow = daemon.prepare_object_data(tr, frames, poses, nlz_col=5,
                                      gt_boxes=gts, gt_ids=ids)
    assert daemon.NUMPY_FRAMES - numpy0 == 5
    assert_same(got, slow)

    sizes = {10: np.array([4.0, 2.0, 1.5]), 11: np.array([5.0, 2.2, 1.7])}
    centers = {10: got[10]["boxes_global"][:, :3] + 0.1}
    headings = {12: np.full(5, 0.25)}
    iou_ref = ref_daemon.generate_iou_gt(want, sizes, centers, headings)
    iou = daemon.generate_iou_gt(got, sizes, centers, headings)
    assert_same(iou_ref, iou)
    assert (iou[99] == 0).all() and (iou[10] > 0.3).all()
    drop = [{"boxes": np.ones((1, 7)), "scores": [0.2], "labels": [1]}] * 5
    scores = {k: np.full(len(v["score"]), 0.5) for k, v in got.items()}
    kw = dict(grm_sizes=sizes, prm_centers=centers, prm_headings=headings,
              crm_scores=scores, drop_data=drop)
    assert_same(ref_daemon.combine_output(want, **kw),
                daemon.combine_output(got, **kw))
    assert_same(ref_daemon.combine_output(want), daemon.combine_output(got))
    assert_same(ref_daemon.crop_object_points(frames[0], gts[0]),
                daemon.crop_object_points(frames[0], gts[0]))


# the leaves with no effect on the output (see the module docstring)
NO_EFFECT = {"grm": {"dec0.self_attn.key.bias", "dec0.cross_attn.key.bias",
                     "mem_pos.Dense_1.bias"},
             "crm": set()}
NO_EFFECT["prm"] = NO_EFFECT["grm"]
KIND_DS = {"grm": "WaymoGeometryDataset", "prm": "WaymoPositionDataset",
           "crm": "WaymoConfidenceDataset"}


@pytest.mark.parametrize("kind", sorted(KIND_DS))
def test_trainer_steps_on_dataset_batches(kind):
    """3 optimizer steps (adam_onecycle, weight decay, norm clip) of the
    port's Trainer against the reference's, on 3 collated batches of 4
    training samples of the refine dataset."""
    ds = DATASETS.get(KIND_DS[kind])(
        dict(DS_CFG[KIND_DS[kind]], AUGMENT=True), "Vehicle", True,
        records=list(cases.object_records(8).values()),
        rng=np.random.RandomState(2))
    order = np.random.RandomState(3).randint(len(ds), size=12)
    batches = [ds.collate_batch([ds[i] for i in order[j:j + 4]])
               for j in range(0, 12, 4)]
    jm = ref_model(kind)
    v = cases.flax_variables(jm, kind)
    model = port_model(kind, v)
    tx, _ = ref_build_optimizer(RefConfig(cases.OPT), 10, params=v["params"])
    ref = RefTrainer(make_loss_fn(cases.ref_cfg(kind), jm), tx,
                     mesh=make_mesh(devices=jax.devices()[:1]))
    ref.init_state({"params": v["params"]})
    trainer = Trainer(model, build_optimizer(cases.OPT, 10, model))
    noise = None
    for b in batches:
        loss_ref, _, _ = ref.step(b)
        loss, _, _ = trainer.step(trainer.to_device(b))
        assert abs(float(loss) - float(loss_ref)) <= 1e-4 * abs(
            float(loss_ref))
        zero = {n for n, p in model.named_parameters()
                if p.grad.abs().max() <= 1e-6}
        noise = zero if noise is None else noise & zero
    assert noise == NO_EFFECT[kind]
    want = jax.tree.map(np.asarray, ref.state["params"])
    flat = to_flax({n: p for n, p in model.named_parameters()
                    if n not in noise})["params"]
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        keys = [p.key for p in path]
        node = flat
        for part in keys[:-1]:
            node = node.get(part, {})
        if keys[-1] in node:        # else a leaf with no effect
            assert np.abs(a - node[keys[-1]]).max() <= 1e-4, keys
    batch = cases.BATCHES[kind](20)
    ref_out = ref_forward(jm, {"params": want}, kind, batch)
    got_out = port_forward(model, kind, batch)
    for k in ref_out:
        assert close(ref_out[k], got_out[k].numpy(), 1e-4), k

"""The port's detection data path (detzero_tpu_torch.data) against the
reference's (detzero_tpu.data), bit for bit: the loaders' first two batches
over SyntheticWaymoDataset (configs/det_model_cfgs/
centerpoint_synthetic_cpu.yaml) and over a 3-frame, 2-sweep
WaymoDetectionDataset tree with 9-wide GT, in training mode (all four
augmentors, an in-memory GT database), in test mode and with TTA; the
reference draws from numpy's global generator after np.random.seed(s), the
port from RandomState(s).  Also merge_sweeps, the TTA inversion, the
processor's sampling, translation, the polar encoder and the prediction
dicts and evaluation."""

import copy

import numpy as np
import pytest
import torch

from detzero_tpu.core.config import Config as RefConfig
from detzero_tpu.core.config import cfg_from_yaml_file as ref_cfg_from_yaml
from detzero_tpu.data import augmentor as ref_augmentor
from detzero_tpu.data import dataset as ref_dataset
from detzero_tpu.data import point_encoder as ref_encoder
from detzero_tpu.data import processor as ref_processor
from detzero_tpu.data import tta as ref_tta
from detzero_tpu.data import waymo_dataset as ref_waymo
from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
from detzero_tpu_torch.data import augmentor, dataset, point_encoder
from detzero_tpu_torch.data import processor, tta, waymo_dataset

import torch_data_cases as cases

SYNTHETIC = "configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml"
SEED = 7


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return cases.write_tree(tmp_path_factory.mktemp("waymo"))


def _configs(kind, tree, training, tta_list=None):
    """(reference config, port config) of one case."""
    if kind == "synthetic":
        ref = ref_cfg_from_yaml(SYNTHETIC, RefConfig())
        got = cfg_from_yaml_file(SYNTHETIC, Config())
        assert ref == got
        for c in (ref, got):
            c["DATA_AUGMENTOR"] = {"AUG_CONFIG_LIST": cases.augmentors()}
    else:
        ref, got = (cls(cases.tree_cfg(tree)) for cls in (RefConfig, Config))
    if tta_list is not None:
        for c in (ref, got):
            c["TTA"] = True
            c["TTA_CONFIG"] = {"TTA_LIST": list(tta_list)}
    return ref, got


def batches_of_both(kind, tree, training, tta_list=None, n=2):
    """The first n batches of the reference's and the port's loader."""
    ref_cfg, cfg = _configs(kind, tree, training, tta_list)
    name = "SyntheticWaymoDataset" if kind == "synthetic" \
        else "WaymoDetectionDataset"
    db = cases.gt_database()
    np.random.seed(SEED)
    ref_ds = getattr(ref_waymo, name)(ref_cfg, ref_cfg["CLASS_NAMES"],
                                      training=training)
    ds = getattr(waymo_dataset, name)(cfg, cfg["CLASS_NAMES"],
                                      training=training,
                                      rng=np.random.RandomState(SEED))
    if training:
        ref_ds.augmentor.queue[0][0].set_database(copy.deepcopy(db))
        ds.augmentor.queue[0][0].set_database(copy.deepcopy(db))
    ref_it = epochs(ref_waymo.build_dataloader(ref_ds, 2, shuffle=True,
                                               seed=1))
    it = epochs(waymo_dataset.build_dataloader(ds, 2, shuffle=True, seed=1))
    ref = [next(ref_it) for _ in range(n)]
    return ref, [next(it) for _ in range(n)], ref_ds, ds


def epochs(loader):
    """Batches of epoch 0, then 1, ... (the tree's 3 frames make one batch
    of 2 an epoch), as train_det iterates them."""
    ep = 0
    while True:
        yield from loader(ep)
        ep += 1


def assert_same(a, b, where=""):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert a.shape == b.shape and np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize("kind,training,tta_list", [
    ("synthetic", True, None), ("synthetic", False, None),
    ("tree", True, None), ("tree", False, None),
    ("tree", False, ["flip_x", "rot_0.39269908", "scale_0.95"])])
def test_loader_batches_bit_for_bit(tree, kind, training, tta_list):
    ref, got, *_ = batches_of_both(kind, tree, training, tta_list)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert_same(a, b, f"batch {i}")
    b = got[0]
    n = 2 * (1 + len(tta_list or []))
    assert b["points"].shape == (n, 4096 if kind == "synthetic" else 2048, 6)
    assert b["points_valid"].any(1).all()
    if kind == "tree":
        assert b["gt_boxes"].shape == (n, 8, 9)      # velocities kept
        assert b["gt_valid"].any()
    if training:
        # the world transforms ran
        assert not np.allclose(b["aug_matrix_inv"][0], np.eye(3))


def test_tree_reads_the_sweeps(tree):
    """Two sweeps merged: the current frame's non-NLZ points and the
    previous frame's, time offsets 0 and -0.1, cut to the budget."""
    _, got, _, ds = batches_of_both("tree", tree, False, n=2)
    assert len(ds) == 3
    seen = set()
    for b in got:
        for pts, valid, frame in zip(b["points"], b["points_valid"],
                                     b["frame_id"]):
            seen.add(frame)
            offsets = set(np.unique(pts[valid, 5]).tolist())
            if frame == 0:                   # no earlier sweep
                assert offsets == {0.0} and not valid.all()
            else:                            # ~2700 points > 2048
                assert offsets == {0.0, float(np.float32(-0.1))}
                assert valid.all()
    assert 0 in seen and len(seen) > 1


def test_merge_sweeps_and_sweep_idxs():
    rng = np.random.RandomState(0)
    cur = rng.randn(300, 6).astype(np.float32)
    cur[:, 5] = np.where(rng.rand(300) < 0.2, 1.0, -1.0)
    sweeps = [rng.randn(200, 6).astype(np.float32) for _ in range(3)]
    for s in sweeps:
        s[:, 5] = -1.0
    poses = [np.eye(4) + np.pad(rng.randn(3, 4) * 0.1, ((0, 1), (0, 0)))
             for _ in range(4)]
    args = (cur, poses[0], sweeps, poses[1:], [-0.1, -0.2, -0.3])
    assert_same(ref_dataset.merge_sweeps(*args), dataset.merge_sweeps(*args))
    for i in range(6):
        for sc in ([-4, 0], [-1, 0], [0, 0]):
            assert ref_dataset.get_sweep_idxs(i, sc, 6) == \
                dataset.get_sweep_idxs(i, sc, 6)


@pytest.mark.parametrize("name", ["original", *ref_tta.DEFAULT_TTA])
def test_tta_apply_and_invert(name):
    rng = np.random.RandomState(1)
    pts = rng.randn(50, 6).astype(np.float32)
    boxes = rng.randn(20, 9)
    assert_same(ref_tta._apply(pts, name), tta._apply(pts, name))
    assert_same(ref_tta.invert_boxes(boxes, name),
                tta.invert_boxes(boxes, name))


def test_processor_sampling_and_translation():
    """The queue steps no config of the repo sets: near/far sampling and
    world translation, on the same draws."""
    rng = np.random.RandomState(2)
    pts = rng.uniform(-70, 70, (5000, 6)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-60, 60, (6, 3)),
                            rng.uniform(1, 4, (6, 3)),
                            rng.uniform(-3, 3, (6, 3))], 1).astype(np.float32)
    queue = [{"NAME": "shuffle_points"},
             {"NAME": "sample_points", "NUM_POINTS": {"train": 3000}}]
    pc = [-75.2, -75.2, -2, 75.2, 75.2, 4]
    for n in (3000, 1000):       # far points fewer, then more, than asked
        queue[1]["NUM_POINTS"]["train"] = n
        np.random.seed(3)
        ref = ref_processor.DataProcessor(queue, pc, True, 4096)(
            {"points": pts.copy()})
        got = processor.DataProcessor(queue, pc, True,
                                      np.random.RandomState(3), 4096)(
            {"points": pts.copy()})
        assert_same(ref, got)
    cfg = [{"NAME": "random_world_translation",
            "NOISE_TRANSLATE_STD": [0.2, 0.2, 0.1]}]
    np.random.seed(4)
    ref = ref_augmentor.DataAugmentor(cfg, cases.CLASS_NAMES)(
        {"points": pts.copy(), "gt_boxes": boxes.copy()})
    got = augmentor.DataAugmentor(cfg, cases.CLASS_NAMES,
                                  np.random.RandomState(4))(
        {"points": pts.copy(), "gt_boxes": boxes.copy()})
    assert_same(ref, got)


def test_polar_encoder():
    pts = np.random.RandomState(5).randn(40, 6).astype(np.float32)
    ref = ref_encoder.PolarPointFeatureEncoder(cases.FEATURES,
                                               cases.FEATURES)(pts)
    got = point_encoder.PolarPointFeatureEncoder(cases.FEATURES,
                                                 cases.FEATURES)(pts)
    assert_same(ref, got)


def test_prediction_dicts_and_no_evaluation(tree):
    """generate_prediction_dicts takes the port's tensors (the reference's
    numpy arrays) and gives the reference's dicts; evaluation gives the
    reference's table and results: the synthetic dataset's exactly as the
    reference's, the tree's as the reference's evaluator on the boxes and
    the infos' GT cut to 7 columns (the reference's own evaluation raises
    on 9-wide boxes, the tree's GT and the detections with velocity)."""
    from detzero_tpu.pipeline import evaluator as ref_evaluator

    ref_batches, batches, ref_ds, ds = batches_of_both("tree", tree, False,
                                                       n=1)
    rng = np.random.RandomState(6)
    preds = {"boxes": rng.randn(2, 16, 9).astype(np.float32),
             "scores": rng.rand(2, 16).astype(np.float32),
             "labels": rng.randint(0, 3, (2, 16)).astype(np.int32),
             "mask": rng.rand(2, 16) > 0.4}
    ref = ref_ds.generate_prediction_dicts(ref_batches[0], preds)
    got = ds.generate_prediction_dicts(
        batches[0], {k: torch.from_numpy(v) for k, v in preds.items()})
    assert_same(ref, got)
    infos = [ds.infos[i] for i in batches[0]["frame_id"]]
    for d, info in zip(got, infos):        # detections near the GT
        d["boxes_lidar"][:3, :7] = info["annos"]["gt_boxes_lidar"][:3, :7]
        d["name"][:3] = info["annos"]["name"][:3]
    ds.infos = ref_ds.infos = infos
    gts = [{"gt_boxes": i["annos"]["gt_boxes_lidar"][:, :7],
            "name": i["annos"]["name"], "num_points": np.zeros(0)}
           for i in infos]
    want = ref_evaluator.evaluate_detection(
        [{**d, "boxes_lidar": d["boxes_lidar"][:, :7]} for d in got], gts,
        class_names=tuple(cases.CLASS_NAMES))
    assert want["Vehicle"]["AP_L1"] > 0
    assert ds.evaluation(got, cases.CLASS_NAMES) == (
        ref_evaluator.format_results_table(want), want)
    with pytest.raises(ValueError, match="reshape"):
        ref_ds.evaluation(got, cases.CLASS_NAMES)
    synth = [pkg.SyntheticWaymoDataset(load(SYNTHETIC, cls()),
                                       cases.CLASS_NAMES, training=False)
             for pkg, load, cls in ((ref_waymo, ref_cfg_from_yaml, RefConfig),
                                    (waymo_dataset, cfg_from_yaml_file,
                                     Config))]
    for d, i in zip(got, (3, 17)):
        d["frame_id"] = i
        d["boxes_lidar"][:2, :7] = synth[1].generate_scene(i)[1][:2]
    got = [{**d, "boxes_lidar": d["boxes_lidar"][:, :7]} for d in got]
    for mode in ("envelope", "waymo101"):
        a = synth[0].evaluation(got, cases.CLASS_NAMES, ap_mode=mode)
        assert synth[1].evaluation(got, cases.CLASS_NAMES, ap_mode=mode) == a

"""The port's host utilities against the JAX package's on the same seeded
inputs: utils/common.py, utils/kitti_convert.py and tools/eval_oracle.py
bit for bit (numpy on both sides), ops/kde.py (torch against jnp) within
1e-6; utils/visualize.py's headless BEV render where matplotlib exists
and its open3d functions' refusal where open3d does not; and the port's
evaluator held to the port's oracle as tests/test_eval_oracle_ab.py holds
the reference's evaluator to the reference's oracle."""

import numpy as np
import pytest
import torch

from detzero_tpu.ops import kde as ref_kde
from detzero_tpu.utils import common as ref_common
from detzero_tpu.utils import kitti_convert as ref_kc
from detzero_tpu_torch.ops import kde
from detzero_tpu_torch.pipeline.evaluator import evaluate_detection
from detzero_tpu_torch.tools import eval_oracle
from detzero_tpu_torch.utils import common, kitti_convert as kc, visualize
from tools import eval_oracle as ref_oracle

from test_eval_oracle_ab import CLASSES, _oracle_inputs, _random_scene


def _boxes(n, rng):
    return np.concatenate([
        rng.uniform(-30, 30, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(1, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
        axis=1)


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind in "fc")
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


# ----------------------------------------------------------------------
# utils/common.py


@pytest.mark.parametrize("seed", [0, 1])
def test_circle_nms(seed):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-10, 10, (200, 2))
    scores = rng.rand(200)
    for radius, post_max in ((1.0, None), (2.5, None), (1.5, 7)):
        _same(common.circle_nms(centers, scores, radius, post_max),
              ref_common.circle_nms(centers, scores, radius, post_max))


def test_remove_points_in_boxes3d():
    rng = np.random.RandomState(2)
    pts = rng.uniform(-30, 30, (3000, 4))
    pts[:, 2] = rng.uniform(-2, 2, 3000)
    boxes = _boxes(12, rng)
    got = common.remove_points_in_boxes3d(pts, boxes)
    _same(got, ref_common.remove_points_in_boxes3d(pts, boxes))
    assert 0 < len(got) < len(pts)


def test_drop_info_with_name():
    rng = np.random.RandomState(3)
    names = rng.choice(["Vehicle", "unknown", "Cyclist"], 20)
    info = {"name": names, "gt_boxes": _boxes(20, rng), "meta": "x",
            "num_points": list(rng.randint(0, 50, 20))}
    for name in ("unknown", "Cyclist"):
        _same(common.drop_info_with_name(info, name),
              ref_common.drop_info_with_name(info, name))


def test_multi_processing_keeps_order():
    items = list(range(-6, 6))
    for workers in (1, 2):
        assert common.multi_processing(abs, items, workers=workers) == \
            ref_common.multi_processing(abs, items, workers=workers) == \
            [abs(x) for x in items]


# ----------------------------------------------------------------------
# utils/kitti_convert.py


def _calib(rng):
    return dict(P2=rng.randn(3, 4) + np.eye(3, 4) * 700,
                R0=np.linalg.qr(rng.randn(3, 3))[0],
                Tr_velo_to_cam=np.concatenate(
                    [np.linalg.qr(rng.randn(3, 3))[0], rng.randn(3, 1)], 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_kitti_convert(seed):
    rng = np.random.RandomState(seed)
    boxes = _boxes(16, rng)
    for kw in ({}, _calib(rng)):
        calib, ref_calib = kc.SimpleCalib(**kw), ref_kc.SimpleCalib(**kw)
        pts = rng.randn(10, 3) * 10
        for fn in ("lidar_to_rect", "rect_to_lidar", "rect_to_img"):
            _same(getattr(calib, fn)(pts), getattr(ref_calib, fn)(pts))
        cam = kc.boxes3d_lidar_to_kitti_camera(boxes, calib)
        _same(cam, ref_kc.boxes3d_lidar_to_kitti_camera(boxes, ref_calib))
        _same(kc.boxes3d_kitti_camera_to_lidar(cam, calib),
              ref_kc.boxes3d_kitti_camera_to_lidar(cam, ref_calib))
        for shape in (None, (375, 1242)):
            _same(kc.boxes3d_kitti_camera_to_imageboxes(cam, calib, shape),
                  ref_kc.boxes3d_kitti_camera_to_imageboxes(cam, ref_calib,
                                                            shape))
            _same(kc.boxes3d_lidar_to_imageboxes(boxes, calib, shape),
                  ref_kc.boxes3d_lidar_to_imageboxes(boxes, ref_calib,
                                                     shape))
    fake = kc.boxes3d_kitti_lidar_to_fakelidar(boxes)
    _same(fake, ref_kc.boxes3d_kitti_lidar_to_fakelidar(boxes))
    _same(kc.boxes3d_kitti_fakelidar_to_lidar(fake),
          ref_kc.boxes3d_kitti_fakelidar_to_lidar(fake))
    for bottom in (True, False):
        _same(kc.boxes3d_to_corners3d_kitti_camera(boxes, bottom),
              ref_kc.boxes3d_to_corners3d_kitti_camera(boxes, bottom))


# ----------------------------------------------------------------------
# ops/kde.py


@pytest.mark.parametrize("bandwidth", [0.5, 1.3])
def test_kde_density(bandwidth):
    rng = np.random.RandomState(4)
    xyz = (rng.randn(3, 7, 16, 3) * rng.uniform(0.1, 3, (3, 7, 1, 1))
           ).astype(np.float32)
    found = rng.rand(3, 7, 16) > 0.3
    found[0, 0] = False                      # a ball that found nothing
    found[1, 2] = True
    want = np.asarray(ref_kde.gaussian_kde_density(xyz, found, bandwidth))
    got = kde.gaussian_kde_density(torch.from_numpy(xyz),
                                   torch.from_numpy(found), bandwidth)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got[0, 0] == 0.0 and torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


# ----------------------------------------------------------------------
# tools/eval_oracle.py, and the port's evaluator held to it


@pytest.mark.parametrize("seed,tie", [(0, False), (3, True)])
def test_oracle_equals_reference_oracle(seed, tie):
    preds, gts = _random_scene(np.random.RandomState(seed), n_frames=6,
                               tie_scores=tie)
    op, og = _oracle_inputs(preds, gts)
    _same(eval_oracle.oracle_evaluate(op, og),
          ref_oracle.oracle_evaluate(op, og))


@pytest.mark.parametrize("seed,tie", [(0, False), (1, False), (2, False),
                                      (3, True)])
def test_port_evaluator_matches_port_oracle(seed, tie):
    preds, gts = _random_scene(np.random.RandomState(seed), tie_scores=tie)
    res = evaluate_detection(preds, gts, ap_mode="waymo101")
    ores = eval_oracle.oracle_evaluate(*_oracle_inputs(preds, gts))
    for cls in CLASSES:
        for k in ("AP_L1", "APH_L1", "AP_L2", "APH_L2"):
            assert abs(res[cls][k] - ores[cls][k]) < 5e-3, (cls, k)


# ----------------------------------------------------------------------
# utils/visualize.py


def test_plot_bev_headless(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(0)
    pts = rng.uniform(-20, 20, (500, 3))
    boxes = np.array([[0, 0, 0, 4, 2, 1.5, 0.4], [5, 5, 0, 1, 1, 1.7, 0]])
    p = visualize.plot_bev(pts, pred_boxes=boxes, gt_boxes=boxes[:1],
                           names=["Vehicle", "Pedestrian"],
                           out_path=tmp_path / "bev.png")
    assert p.exists() and p.stat().st_size > 1000
    frames = [{"points": pts, "boxes": boxes, "names": ["Vehicle"] * 2},
              {"points": pts[:100]}]
    paths = visualize.sequence_playback(frames, tmp_path / "seq")
    assert [q.name for q in paths] == ["frame_0000.png", "frame_0001.png"]
    assert all(q.stat().st_size > 1000 for q in paths)


def test_open3d_functions_name_the_fallback(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "open3d", None)
    with pytest.raises(ImportError, match="plot_bev"):
        visualize.boxes_to_lineset(np.zeros((1, 7)))
    with pytest.raises(ImportError, match="plot_bev"):
        visualize.visualize_frame(np.zeros((4, 3)))

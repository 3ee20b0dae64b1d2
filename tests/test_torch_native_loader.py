"""The port's native (C++) sweep loader, detzero_tpu_torch.native, against
its numpy path (atol 1e-5, as tests/test_native_loader.py holds the
reference's) and against the reference's native loader (bit for bit: the
same C++), its refusals (budget truncation, a missing file), its batch
loader and `crop_points_multi` against the numpy oracle; and the port's
WaymoDetectionDataset with USE_NATIVE_LOADER on: seeded loaders of both
packages equal bit for bit, and NATIVE_SAMPLES counting the samples it
read."""

import copy

import numpy as np
import pytest

from detzero_tpu import native as ref_native
from detzero_tpu.core.config import Config as RefConfig
from detzero_tpu.data import waymo_dataset as ref_waymo
from detzero_tpu_torch import native
from detzero_tpu_torch.core.config import Config
from detzero_tpu_torch.data import waymo_dataset
from detzero_tpu_torch.data.dataset import merge_sweeps
from detzero_tpu_torch.ops import box_np

import torch_data_cases as cases


def _write_frame(tmp_path, name, rng, n=200):
    pts = np.zeros((n, 6), np.float32)
    pts[:, :3] = rng.uniform(-10, 10, (n, 3))
    pts[:, 3] = rng.rand(n) * 3          # intensity
    pts[:, 4] = rng.rand(n)              # elongation
    pts[:, 5] = np.where(rng.rand(n) < 0.1, 3.0, -1.0)  # some NLZ points
    p = tmp_path / name
    np.save(p, pts)
    return p, pts


def _poses(rng, n):
    out = []
    for _ in range(n):
        a = rng.uniform(-0.3, 0.3)
        pose = np.eye(4, dtype=np.float32)
        pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        pose[:3, 3] = rng.uniform(-5, 5, 3)
        out.append(pose)
    return out


def test_build_goes_under_build_and_reloads():
    path = native.build()
    assert native.available() and path == native.library_path()
    assert path.parent.parent.name == "detzero_tpu_torch_native"
    assert path.parent.parent.parent.name == "build"
    assert not list(native.SRC.parent.glob("*.so"))
    assert not list(path.parent.glob("*.tmp"))


def test_matches_numpy_merge_and_the_reference(tmp_path):
    """Three sweeps under rotated poses: the native merge equals
    merge_sweeps within 1e-5 and the reference's native merge exactly."""
    rng = np.random.RandomState(0)
    files = [_write_frame(tmp_path, f"s{i}.npy", rng) for i in range(3)]
    poses = _poses(rng, 3)
    inv = np.linalg.inv(poses[0])
    rels = [np.eye(4, dtype=np.float32)] + [
        (inv @ p).astype(np.float32) for p in poses[1:]]
    args = ([p for p, _ in files], rels, [0.0, -0.1, -0.2])
    out, n = native.load_merged_sample(*args, out_stride=6, budget=1024)
    want = merge_sweeps(files[0][1], poses[0], [f[1] for f in files[1:]],
                        poses[1:], [-0.1, -0.2])
    assert n == len(want)
    np.testing.assert_allclose(out[:n], want, atol=1e-5)
    assert (out[n:] == 0).all()
    ref_out, ref_n = ref_native.load_merged_sample(*args, out_stride=6,
                                                   budget=1024)
    assert ref_n == n and np.array_equal(ref_out, out)


def test_budget_truncation_and_missing_file(tmp_path):
    rng = np.random.RandomState(1)
    p, _ = _write_frame(tmp_path, "f.npy", rng, n=500)
    out, n = native.load_merged_sample([p], [np.eye(4)], [0.0],
                                       out_stride=6, budget=64)
    ref_out, ref_n = ref_native.load_merged_sample(
        [p], [np.eye(4)], [0.0], out_stride=6, budget=64)
    assert n == ref_n == 64 and np.array_equal(out, ref_out)
    for pkg in (native, ref_native):
        with pytest.raises(IOError):
            pkg.load_merged_sample([tmp_path / "nope.npy"], [np.eye(4)],
                                   [0.0], out_stride=6, budget=16)
        with pytest.raises(IOError):
            pkg.load_batch([[p], [tmp_path / "nope.npy"]],
                           [[np.eye(4)]] * 2, [[0.0]] * 2, out_stride=6,
                           budget=16)


def test_batch_parallel(tmp_path):
    rng = np.random.RandomState(2)
    paths, all_pts = [], []
    for i in range(6):
        p, pts = _write_frame(tmp_path, f"b{i}.npy", rng)
        paths.append([p])
        all_pts.append(pts)
    eye = np.eye(4, dtype=np.float32)
    args = (paths, [[eye]] * 6, [[0.0]] * 6)
    out, mask = native.load_batch(*args, out_stride=6, budget=512,
                                  n_threads=4)
    assert out.shape == (6, 512, 6)
    for i in range(6):
        keep = all_pts[i][:, 5] == -1
        assert mask[i].sum() == keep.sum()
        one, n = native.load_merged_sample(*(a[i] for a in args),
                                           out_stride=6, budget=512)
        assert n == mask[i].sum() and np.array_equal(one, out[i])
    ref_out, ref_mask = ref_native.load_batch(*args, out_stride=6,
                                              budget=512, n_threads=4)
    assert np.array_equal(out, ref_out) and np.array_equal(mask, ref_mask)


def test_crop_points_multi_matches_numpy_oracle():
    rng = np.random.RandomState(3)
    pts = rng.uniform(-30, 30, (20000, 5)).astype(np.float32)
    boxes = np.concatenate([
        rng.uniform(-25, 25, (9, 2)), np.zeros((9, 1)),
        rng.uniform(1, 5, (9, 3)), rng.uniform(-3, 3, (9, 1))],
        axis=1).astype(np.float32)
    got = native.crop_points_multi(pts, boxes, 1.1)
    ref = ref_native.crop_points_multi(pts, boxes, 1.1)
    assert sum(len(g) for g in got) > 0
    for j, b in enumerate(boxes):
        eb = b.copy()
        eb[3:6] *= 1.1
        want = pts[box_np.points_in_rotated_box(pts, eb)]
        assert got[j].shape == want.shape
        np.testing.assert_allclose(
            got[j][np.lexsort(got[j].T)], want[np.lexsort(want.T)])
        assert np.array_equal(got[j], ref[j])
    assert native.crop_points_multi(pts, np.zeros((0, 7))) == []
    out = native.crop_points_multi(np.zeros((0, 4), np.float32), boxes)
    assert len(out) == 9 and all(len(o) == 0 for o in out)


@pytest.mark.parametrize("training", [True, False])
def test_seeded_loaders_bit_for_bit(tmp_path, training):
    """The tiny tree (2 sweeps of 2000 points, 10% NLZ, against a budget of
    2048): the reference's and the port's loaders, both on the native
    path, give equal batches; the port's native and numpy paths give the
    same sample where no sweep is cut, within 1e-5."""
    tree = cases.write_tree(tmp_path)
    out = []
    for pkg, cfg_cls, use in ((ref_waymo, RefConfig, True),
                              (waymo_dataset, Config, True),
                              (waymo_dataset, Config, False)):
        cfg = cfg_cls(cases.tree_cfg(tree))
        cfg["USE_NATIVE_LOADER"] = use
        kw = {} if pkg is ref_waymo else {"rng": np.random.RandomState(7)}
        np.random.seed(7)
        ds = pkg.WaymoDetectionDataset(cfg, cases.CLASS_NAMES, training, **kw)
        if training:
            ds.augmentor.queue[0][0].set_database(
                copy.deepcopy(cases.gt_database()))
        before = waymo_dataset.NATIVE_SAMPLES
        loader = pkg.build_dataloader(ds, 2, shuffle=True, seed=1)
        out.append([b for ep in range(2) for b in loader(ep)])
        if pkg is waymo_dataset:
            assert waymo_dataset.NATIVE_SAMPLES - before == (4 if use else 0)
    ref, got, numpy_path = out
    assert len(ref) == len(got) == 2
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == b[k].dtype and np.array_equal(v, b[k]), k
            else:
                assert str(v) == str(b[k]), k
    if not training:
        # frame 0 has no earlier sweep and fits the budget: there the two
        # paths read the same points (test mode keeps their order); over
        # the budget the native path cuts before the range filter, the
        # numpy path after it, as in the reference
        seen = 0
        for a, b in zip(got, numpy_path):
            for i, frame in enumerate(a["frame_id"]):
                assert b["frame_id"][i] == frame
                if frame == 0:
                    seen += 1
                    np.testing.assert_allclose(
                        a["points"][i], b["points"][i], atol=1e-5)
                    assert np.array_equal(a["points_valid"][i],
                                          b["points_valid"][i])
        assert seen

"""Waymo preprocessing of the port (data/waymo_preprocess.py,
tools/create_waymo_infos.py) against the reference's on the reference's
own synthetic records (tests/test_waymo_tfrecord.py's `_make_frame`, with
a rolling-shutter pose range image and a second return added to one
frame): `range_image_to_points`, `process_single_sequence`,
`create_waymo_infos` and `create_gt_database` give .npy files, infos and a
GT database equal to the reference's, bit for bit.
"""

import pickle

import numpy as np
import pytest

from detzero_tpu.data import waymo_preprocess as ref_wp
from detzero_tpu.data.tfrecord_io import write_tfrecord
from detzero_tpu_torch.data import waymo_preprocess as wp
from detzero_tpu_torch.protos import waymo_dataset_pb2 as wpb
from detzero_tpu_torch.tools import create_waymo_infos

import test_waymo_tfrecord as tw


def shutter_pose(frame, seed):
    """A per-pixel [roll, pitch, yaw, x, y, z] pose image near the frame's
    pose: yaw and position drift along the columns, the first rows padding
    (all zero), as the TOP lidar's range_image_pose carries."""
    rng = np.random.RandomState(seed)
    pose = np.asarray(frame.pose.transform, np.float64).reshape(4, 4)
    cols = np.linspace(0, 1, tw.W)[None, :]
    p = np.zeros((tw.H, tw.W, 6), np.float32)
    p[..., 0:2] = rng.uniform(-0.01, 0.01, 2)
    p[..., 2] = 0.05 * cols
    p[..., 3:6] = pose[:3, 3] + np.stack([cols * 0.8, cols * 0.1,
                                          cols * 0.0], -1)
    p[:2] = 0
    return p


def sequence_records(seed0=0, n=3):
    """n frames of `_make_frame`; frame 1 also carries a second return and
    rolling-shutter poses on both returns."""
    frames = []
    for i in range(n):
        frame, ri, _ = tw._make_frame(seed0 + i, timestamp=1000 + 100 * i)
        if i == 1:
            laser = frame.lasers[0]
            pose_ri = ref_wp.encode_matrix(shutter_pose(frame, i))
            laser.ri_return1.range_image_pose_compressed = pose_ri
            ri2 = ri.copy()
            ri2[..., 0] *= 1.05
            laser.ri_return2.range_image_compressed = \
                ref_wp.encode_matrix(ri2)
            laser.ri_return2.range_image_pose_compressed = pose_ri
        frames.append(frame)
    return [f.SerializeToString() for f in frames]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    for s, seq in enumerate(("segment-0001", "segment-0002")):
        write_tfrecord(root / f"{seq}_with_camera_labels.tfrecord",
                       sequence_records(10 * s))
    return root


def assert_tree_equal(a, b, path=""):
    """Equal types, keys and values; arrays equal in dtype, shape and
    every element."""
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
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def test_range_image_to_points_with_rolling_shutter():
    frame, ri, _ = tw._make_frame(5)
    calib = frame.context.laser_calibrations[0]
    pose_ri = shutter_pose(frame, 5)
    fp = np.asarray(frame.pose.transform).reshape(4, 4)
    for args in ((), (pose_ri, fp)):
        ref = ref_wp.range_image_to_points(ri, calib, *args)
        port_frame = wpb.Frame()
        port_frame.ParseFromString(frame.SerializeToString())
        got = wp.range_image_to_points(
            ri, port_frame.context.laser_calibrations[0], *args)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.abs(got[0] - ref_wp.range_image_to_points(ri, calib)[0]).max() \
        > 0.1                  # the compensation moved the points


def test_process_single_sequence_equal(raw, tmp_path):
    path = raw / "segment-0001_with_camera_labels.tfrecord"
    want = ref_wp.process_single_sequence(path, tmp_path / "ref")
    got = wp.process_single_sequence(path, tmp_path / "port")
    assert_tree_equal(want, got)
    assert len(got) == 3 and got[1]["annos"]["gt_boxes_lidar"].shape == (2, 7)
    names = sorted(p.name for p in (tmp_path / "ref" / "segment-0001")
                   .iterdir())
    assert names == ["0000.npy", "0001.npy", "0002.npy"]
    for n in names:
        a = (tmp_path / "ref" / "segment-0001" / n).read_bytes()
        assert (tmp_path / "port" / "segment-0001" / n).read_bytes() == a
    _, ri, _ = tw._make_frame(1)          # both returns of frame 1
    second = np.load(tmp_path / "port" / "segment-0001" / "0001.npy")
    assert len(second) == 2 * int((ri[..., 0] > 0).sum()) > 200
    assert (tmp_path / "port" / "segment-0001.pkl").read_bytes() == \
        (tmp_path / "ref" / "segment-0001.pkl").read_bytes()
    # idempotent: the info pkl is read back, not rebuilt
    assert_tree_equal(wp.process_single_sequence(path, tmp_path / "port"),
                      got)


def test_create_infos_and_gt_database_equal(raw, tmp_path):
    split = tmp_path / "ImageSets" / "val.txt"
    split.parent.mkdir()
    split.write_text("segment-0001\nsegment-0002\n")
    ref_out, port_out = tmp_path / "ref" / "processed", \
        tmp_path / "port" / "processed"
    want = ref_wp.create_waymo_infos(raw, ref_out, split, workers=2)
    got = create_waymo_infos.main([
        "--stage", "infos", "--raw_dir", str(raw), "--out_dir",
        str(port_out), "--split_file", str(split), "--workers", "2"])
    assert_tree_equal(want, got)
    assert len(got) == 6
    assert (tmp_path / "port" / "waymo_infos_val.pkl").read_bytes() == \
        (tmp_path / "ref" / "waymo_infos_val.pkl").read_bytes()

    with open(tmp_path / "ref" / "waymo_infos_val.pkl", "rb") as f:
        ref_db = ref_wp.create_gt_database(pickle.load(f), ref_out,
                                           tmp_path / "ref_db.pkl")
    db = create_waymo_infos.main([
        "--stage", "gt_database", "--infos_path",
        str(tmp_path / "port" / "waymo_infos_val.pkl"), "--out_dir",
        str(port_out), "--db_out", str(tmp_path / "port_db.pkl")])
    assert_tree_equal(ref_db, db)
    assert sum(len(v) for v in db.values()) > 0
    assert (tmp_path / "port_db.pkl").read_bytes() == \
        (tmp_path / "ref_db.pkl").read_bytes()


def test_refuses_a_frame_without_pose(tmp_path):
    frame, _, _ = tw._make_frame(0)
    frame.ClearField("pose")
    path = tmp_path / "segment-0009.tfrecord"
    write_tfrecord(path, [frame.SerializeToString()])
    with pytest.raises(ValueError, match="pose.transform has 0 values"):
        wp.process_single_sequence(path, tmp_path / "out")
    with pytest.raises(FileNotFoundError, match="segment-0010"):
        split = tmp_path / "s.txt"
        split.write_text("segment-0010")
        wp.create_waymo_infos(tmp_path, tmp_path / "out", split, workers=1)

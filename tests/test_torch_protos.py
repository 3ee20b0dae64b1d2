"""The port's protobuf wire codec (detzero_tpu_torch/protos) and TFRecord
framing (data/tfrecord_io.py, the native masked CRC-32C) against the
reference's generated classes (google.protobuf) and tfrecord_io:

  * seeded `Frame`s built alike through both packages (1-2 lasers, both
    returns, beam inclinations set and unset, a rolling-shutter pose range
    image, labels with fields set to 0, empty strings) and `Objects` of 0,
    1 and many objects serialize to equal bytes;
  * each package decodes the other's bytes, field for field;
  * the port decodes a packed `transform` (proto2 writes it unpacked) and
    skips fields its schema lacks, of every wire type;
  * tfrecord files written by both packages are equal, the native CRC
    equals the reference's on random buffers, and a corrupt record fails
    `verify_crc`.
"""

import numpy as np
import pytest

from detzero_tpu.data import tfrecord_io as ref_tfr
from detzero_tpu.data import waymo_preprocess as ref_wp
from detzero_tpu.protos import waymo_dataset_pb2 as ref_wpb
from detzero_tpu.protos import waymo_metrics_pb2 as ref_mpb
from detzero_tpu_torch import native
from detzero_tpu_torch.data import tfrecord_io as tfr
from detzero_tpu_torch.data import waymo_preprocess as wp
from detzero_tpu_torch.protos import waymo_dataset_pb2 as wpb
from detzero_tpu_torch.protos import waymo_metrics_pb2 as mpb
from detzero_tpu_torch.protos import wire

H, W = 16, 64

# (seed, lasers, second return, explicit inclinations, rolling shutter)
FRAMES = [(0, 1, False, False, False), (1, 2, True, True, False),
          (2, 1, True, False, True), (3, 2, False, True, True)]


def build_frame(pb, prep, seed, n_lasers, second, inclinations, shutter):
    """A Frame built with module `pb` and its package's `encode_matrix`,
    from draws that depend on the arguments only."""
    rng = np.random.RandomState(seed)
    f = pb.Frame()
    f.timestamp_micros = int(rng.randint(0, 2 ** 40))
    f.context.name = "" if seed % 2 else f"ctx_{seed}"
    pose = np.eye(4)
    pose[:3, 3] = rng.randn(3) * 10
    f.pose.transform.extend(pose.ravel().tolist())
    for li in range(n_lasers):
        calib = f.context.laser_calibrations.add()
        calib.name = pb.LaserName.TOP + li
        if inclinations:
            calib.beam_inclinations.extend(
                np.sort(rng.uniform(-0.3, 0.05, H)).tolist())
        calib.beam_inclination_min = -0.3
        calib.beam_inclination_max = 0.0 if li else 0.07   # a zero set
        extr = np.eye(4)
        extr[:3, 3] = rng.randn(3)
        calib.extrinsic.transform.extend(extr.ravel().tolist())
        laser = f.lasers.add()
        laser.name = pb.LaserName.TOP + li
        for ret in ((laser.ri_return1, laser.ri_return2) if second
                    else (laser.ri_return1,)):
            ri = rng.uniform(0, 50, (H, W, 4)).astype(np.float32)
            ri[rng.rand(H, W) < 0.3] = 0
            ret.range_image_compressed = prep.encode_matrix(ri)
            if shutter and li == 0:
                pose_ri = np.zeros((H, W, 6), np.float32)
                pose_ri[..., 2] = rng.uniform(-0.1, 0.1)
                pose_ri[..., 3:] = rng.randn(3)
                ret.range_image_pose_compressed = prep.encode_matrix(pose_ri)
            ret.camera_projection_compressed = b""
    for k in range(3 + seed):
        lbl = f.laser_labels.add()
        b = rng.randn(7)
        lbl.box.center_x, lbl.box.center_y, lbl.box.center_z = b[:3]
        lbl.box.length, lbl.box.width, lbl.box.height = np.abs(b[3:6])
        lbl.box.heading = 0.0 if k == 0 else b[6]
        lbl.type = k % 5
        lbl.id = "" if k == 1 else f"obj_{seed}_{k}"
        lbl.detection_difficulty_level = k % 3
        if k % 2:
            lbl.tracking_difficulty_level = 0
        lbl.num_lidar_points_in_box = 0 if k == 0 else int(rng.randint(500))
    return f


def build_objects(pb, n, seed=0):
    rng = np.random.RandomState(seed)
    objs = pb.Objects()
    for i in range(n):
        o = objs.objects.add()
        o.context_name = f"ctx_{i % 3}" if i % 4 else ""
        o.frame_timestamp_micros = int(rng.randint(0, 2 ** 40))
        b = rng.randn(7)
        for k, v in zip(("center_x", "center_y", "center_z", "length",
                         "width", "height", "heading"), b):
            setattr(o.object.box, k, 0.0 if i == 1 else float(v))
        o.score = float(rng.rand())
        o.object.type = i % 5
        if i % 2:
            o.object.id = f"track_{i}"
        if i == 2:
            o.overlap_with_nlz = 0.0
    return objs


def assert_same(ref, port):
    """Field for field over the port's schema: presence, repeated lengths,
    values (and their Python types) equal."""
    for f in type(port).FIELDS:
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.repeated:
            assert len(a) == len(b), f.name
            if f.kind == "message":
                for x, y in zip(a, b):
                    assert_same(x, y)
            else:
                assert [type(v) for v in a] == [type(v) for v in b], f.name
                assert list(a) == list(b), f.name
        else:
            assert ref.HasField(f.name) == port.HasField(f.name), f.name
            if f.kind == "message":
                assert_same(a, b)
            else:
                assert type(a) is type(b) and a == b, (f.name, a, b)


@pytest.mark.parametrize("spec", FRAMES)
def test_frame_bytes_equal_and_cross_decode(spec):
    ref = build_frame(ref_wpb, ref_wp, *spec)
    port = build_frame(wpb, wp, *spec)
    raw = ref.SerializeToString()
    assert port.SerializeToString() == raw
    got = wpb.Frame()
    got.ParseFromString(raw)
    assert_same(ref, got)
    back = ref_wpb.Frame()
    back.ParseFromString(port.SerializeToString())
    assert_same(back, port)
    # the range images decode alike, the rolling-shutter pose included
    for lr, lp in zip(ref.lasers, got.lasers):
        for rr, rp in ((lr.ri_return1, lp.ri_return1),
                       (lr.ri_return2, lp.ri_return2)):
            for k in ("range_image_compressed",
                      "range_image_pose_compressed"):
                if getattr(rr, k):
                    a = ref_wp.decode_matrix(getattr(rr, k))
                    b = wp.decode_matrix(getattr(rp, k))
                    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 37])
def test_objects_bytes_equal_and_cross_decode(n):
    ref, port = build_objects(ref_mpb, n), build_objects(mpb, n)
    raw = ref.SerializeToString()
    assert port.SerializeToString() == raw
    got = mpb.Objects()
    got.ParseFromString(raw)
    assert_same(ref, got)
    back = ref_mpb.Objects()
    back.ParseFromString(port.SerializeToString())
    assert_same(back, port)


def test_presence_follows_protobuf():
    """Reading a nested message sets nothing; `.extend([])`, `.add()` and
    setting a default value set it, as in the generated classes."""
    for pb in (ref_wpb, wpb):
        f = pb.Frame()
        _ = f.pose.transform, f.context.name
        assert f.SerializeToString() == b"" and not f.HasField("pose")
    cases = [lambda f: f.pose.transform.extend([]),
             lambda f: f.lasers.add(),
             lambda f: setattr(f.context, "name", ""),
             lambda f: setattr(f, "timestamp_micros", -1),
             lambda f: f.laser_labels.add().box.__setattr__("heading", 0.0)]
    for case in cases:
        ref, port = ref_wpb.Frame(), wpb.Frame()
        case(ref)
        case(port)
        assert port.SerializeToString() == ref.SerializeToString()
        assert port.HasField("pose") == ref.HasField("pose")


def test_packed_transform_and_unknown_fields():
    vals = np.random.RandomState(0).randn(16)
    payload = vals.astype("<f8").tobytes()
    packed = wire.tag(1, wire.LEN) + wire.encode_varint(len(payload)) \
        + payload
    t, ref_t = wpb.Transform(), ref_wpb.Transform()
    t.ParseFromString(packed)
    ref_t.ParseFromString(packed)
    assert list(t.transform) == list(ref_t.transform) == vals.tolist()
    # the port writes it unpacked, as proto2 does
    assert t.SerializeToString() == ref_t.SerializeToString() != packed

    frame = build_frame(ref_wpb, ref_wp, *FRAMES[1])
    raw = frame.SerializeToString()
    head = (wire.tag(4, wire.VARINT) + wire.encode_varint(2 ** 40)
            + wire.tag(7, wire.I64) + b"\x01" * 8
            + wire.tag(9, wire.LEN) + wire.encode_varint(3) + b"abc")
    tail = (wire.tag(11, wire.I32) + b"\x02" * 4
            + wire.tag(12, wire.SGROUP) + wire.tag(1, wire.VARINT)
            + b"\x05" + wire.tag(12, wire.EGROUP)
            # a known number with a wire type it cannot take
            + wire.tag(2, wire.LEN) + wire.encode_varint(1) + b"x")
    got = wpb.Frame()
    got.ParseFromString(head + raw + tail)
    assert got.SerializeToString() == raw
    assert_same(frame, got)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000, 65537])
def test_native_masked_crc(n):
    data = np.random.RandomState(n).bytes(n)
    assert native.masked_crc32c(data) == ref_tfr._masked_crc(data)


def test_tfrecord_files_equal(tmp_path):
    recs = [build_frame(ref_wpb, ref_wp, *s).SerializeToString()
            for s in FRAMES] + [b"", b"x" * 3000]
    tfr.write_tfrecord(tmp_path / "port.tfrecord", recs)
    ref_tfr.write_tfrecord(tmp_path / "ref.tfrecord", recs)
    raw = (tmp_path / "port.tfrecord").read_bytes()
    assert raw == (tmp_path / "ref.tfrecord").read_bytes()
    assert list(tfr.read_tfrecord(tmp_path / "ref.tfrecord",
                                  verify_crc=True)) == recs
    bad = bytearray(raw)
    bad[40] ^= 1                  # a byte of the first record's data
    (tmp_path / "bad.tfrecord").write_bytes(bytes(bad))
    assert len(list(tfr.read_tfrecord(tmp_path / "bad.tfrecord"))) == \
        len(recs)
    with pytest.raises(IOError, match="crc"):
        list(tfr.read_tfrecord(tmp_path / "bad.tfrecord", verify_crc=True))
    (tmp_path / "cut.tfrecord").write_bytes(raw[:-3])
    with pytest.raises(IOError, match="truncated"):
        list(tfr.read_tfrecord(tmp_path / "cut.tfrecord"))

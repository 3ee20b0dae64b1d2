"""Waymo raw-data preprocessing (port of
detzero_tpu/data/waymo_preprocess.py; reference detection/tools
waymo_preprocess.py + waymo_utils.py:78-175): tfrecord -> per-frame point
.npy + per-sequence info pkls + GT sampling database.

No TensorFlow and no `google.protobuf`: the records are read by
`data/tfrecord_io.py` (the native library's CRC), the `Frame` is decoded
by the package's own codec (`protos/waymo_dataset_pb2.py`), and the
range-image -> point-cloud math is the reference's NumPy, line for line,
on the port's `ops/box_np.py`, so the .npy files, infos and GT database
equal the reference's bit for bit (tests/test_torch_preprocess.py).

Geometry (mirrors waymo frame_utils semantics):
  * range image (H, W, 4): channels range / intensity / elongation /
    is_in_no_label_zone, zlib-compressed MatrixFloat;
  * row r uses beam inclination[H-1-r] (row 0 = top beam); uniform
    linspace(min, max, H) when explicit inclinations are absent;
  * azimuth(col) = pi - 2*pi*(col+0.5)/W - az_correction with
    az_correction = atan2(extrinsic[1,0], extrinsic[0,0]);
  * vehicle-frame point = extrinsic @ (r * [cos(i)cos(a), cos(i)sin(a),
    sin(i)], 1).
"""

from __future__ import annotations

import pickle
import zlib
from pathlib import Path

import numpy as np

from detzero_tpu_torch.data.tfrecord_io import read_tfrecord
from detzero_tpu_torch.ops import box_np
from detzero_tpu_torch.protos import waymo_dataset_pb2 as wpb

TYPE_MAP = {wpb.Label.TYPE_VEHICLE: "Vehicle",
            wpb.Label.TYPE_PEDESTRIAN: "Pedestrian",
            wpb.Label.TYPE_CYCLIST: "Cyclist",
            wpb.Label.TYPE_SIGN: "Sign"}


def decode_matrix(compressed: bytes) -> np.ndarray:
    mf = wpb.MatrixFloat()
    mf.ParseFromString(zlib.decompress(compressed))
    return np.asarray(mf.data, np.float32).reshape(tuple(mf.shape.dims))


def encode_matrix(arr: np.ndarray) -> bytes:
    mf = wpb.MatrixFloat()
    mf.data.extend(np.asarray(arr, np.float32).ravel().tolist())
    mf.shape.dims.extend(arr.shape)
    return zlib.compress(mf.SerializeToString())


def beam_inclinations(calib, h: int) -> np.ndarray:
    if len(calib.beam_inclinations):
        inc = np.asarray(calib.beam_inclinations, np.float64)
    else:
        inc = np.linspace(calib.beam_inclination_min,
                          calib.beam_inclination_max, h)
    return inc[::-1]  # row 0 = top beam


def _euler_to_rot(roll, pitch, yaw):
    """(...,) eulers -> (..., 3, 3) rotation, R = Rz(yaw) Ry(pitch) Rx(roll)
    (waymo transform_utils.get_rotation_matrix convention)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot = np.empty(np.shape(roll) + (3, 3))
    rot[..., 0, 0] = cy * cp
    rot[..., 0, 1] = cy * sp * sr - sy * cr
    rot[..., 0, 2] = cy * sp * cr + sy * sr
    rot[..., 1, 0] = sy * cp
    rot[..., 1, 1] = sy * sp * sr + cy * cr
    rot[..., 1, 2] = sy * sp * cr - cy * sr
    rot[..., 2, 0] = -sp
    rot[..., 2, 1] = cp * sr
    rot[..., 2, 2] = cp * cr
    return rot


def range_image_to_points(ri: np.ndarray, calib, pose_ri=None,
                          frame_pose=None):
    """(H, W, >=1) range image -> (N, 3) vehicle-frame xyz + (N, C-1)
    extra channels, filtered to range > 0.

    pose_ri (H, W, 6) [roll, pitch, yaw, x, y, z]: per-PIXEL vehicle pose
    in the global frame (the TOP lidar's rolling-shutter ego-motion record,
    waymo range_image_pose).  When given with frame_pose (4, 4), each point
    is lifted to the global frame at its pixel's capture time and brought
    back into THIS frame's vehicle frame — the compensation
    frame_utils.convert_range_image_to_point_cloud applies."""
    h, w = ri.shape[:2]
    extr = np.asarray(calib.extrinsic.transform, np.float64).reshape(4, 4)
    inc = beam_inclinations(calib, h)
    az_corr = np.arctan2(extr[1, 0], extr[0, 0])
    az = np.pi - 2.0 * np.pi * (np.arange(w) + 0.5) / w - az_corr
    r = ri[..., 0]
    cos_i = np.cos(inc)[:, None]
    dirs = np.stack([cos_i * np.cos(az)[None, :],
                     cos_i * np.sin(az)[None, :],
                     np.broadcast_to(np.sin(inc)[:, None], (h, w))], -1)
    pts_l = r[..., None] * dirs
    pts_v = pts_l @ extr[:3, :3].T + extr[:3, 3]
    mask = r > 0
    if pose_ri is not None and frame_pose is not None:
        # pixels with an all-zero pose carry no ego-motion record (padding)
        valid = np.abs(pose_ri).sum(-1) > 0
        rot = _euler_to_rot(pose_ri[..., 0], pose_ri[..., 1],
                            pose_ri[..., 2])
        p_glob = np.einsum("hwij,hwj->hwi", rot, pts_v) + pose_ri[..., 3:6]
        inv = np.linalg.inv(np.asarray(frame_pose, np.float64))
        p_here = p_glob @ inv[:3, :3].T + inv[:3, 3]
        pts_v = np.where(valid[..., None], p_here, pts_v)
    return pts_v[mask].astype(np.float32), ri[mask][:, 1:].astype(np.float32)


def parse_frame(record: bytes):
    frame = wpb.Frame()
    frame.ParseFromString(record)
    return frame


def frame_points(frame) -> np.ndarray:
    """All lasers, both returns -> (N, 6): x y z intensity elongation nlz."""
    calibs = {c.name: c for c in frame.context.laser_calibrations}
    frame_pose = (np.array(frame.pose.transform, np.float64).reshape(4, 4)
                  if len(frame.pose.transform) == 16 else None)
    chunks = []
    for laser in frame.lasers:
        calib = calibs.get(laser.name)
        if calib is None:
            continue
        for ret in (laser.ri_return1, laser.ri_return2):
            if not ret.range_image_compressed:
                continue
            ri = decode_matrix(ret.range_image_compressed)
            pose_ri = None
            if ret.range_image_pose_compressed:
                pose_ri = decode_matrix(ret.range_image_pose_compressed)
            xyz, extra = range_image_to_points(ri, calib, pose_ri,
                                               frame_pose)
            feat = np.zeros((len(xyz), 3), np.float32)
            feat[:, :extra.shape[1]] = extra[:, :3]
            chunks.append(np.concatenate([xyz, feat], axis=1))
    if not chunks:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(chunks, axis=0)


def process_single_sequence(tfrecord_path, out_dir, has_labels: bool = True):
    """tfrecord -> <seq>/NNNN.npy (x, y, z, intensity, elongation, nlz) +
    <seq>.pkl info list (reference waymo_utils.py:175)."""
    seq_name = Path(tfrecord_path).stem.replace("_with_camera_labels", "")
    out = Path(out_dir) / seq_name
    info_path = Path(out_dir) / f"{seq_name}.pkl"
    if info_path.exists():  # idempotent (reference waymo_utils.py:199-202)
        with open(info_path, "rb") as f:
            return pickle.load(f)
    out.mkdir(parents=True, exist_ok=True)

    infos = []
    for idx, record in enumerate(read_tfrecord(tfrecord_path)):
        frame = parse_frame(record)
        arr = frame_points(frame)
        np.save(out / f"{idx:04d}.npy", arr)

        if len(frame.pose.transform) != 16:
            raise ValueError(
                f"frame {idx} of {seq_name}: pose.transform has "
                f"{len(frame.pose.transform)} values (want 16) — schema "
                "skew or corrupt record; refusing a silent identity pose")
        pose = np.array(frame.pose.transform, np.float32).reshape(4, 4)
        info = {"point_cloud": {"lidar_sequence": seq_name, "sample_idx": idx},
                "pose": pose, "frame_id": f"{seq_name}_{idx:03d}",
                "timestamp": frame.timestamp_micros,
                "context_name": frame.context.name}
        if has_labels:
            names, boxes, npts, ids, diffs = [], [], [], [], []
            for obj in frame.laser_labels:
                b = obj.box
                names.append(TYPE_MAP.get(obj.type, "unknown"))
                boxes.append([b.center_x, b.center_y, b.center_z,
                              b.length, b.width, b.height, b.heading])
                npts.append(obj.num_lidar_points_in_box)
                ids.append(obj.id)
                diffs.append(obj.detection_difficulty_level)
            info["annos"] = {
                "name": np.asarray(names),
                "gt_boxes_lidar": np.asarray(boxes, np.float32).reshape(-1, 7),
                "num_points_in_gt": np.asarray(npts),
                "obj_ids": np.asarray(ids),
                "difficulty": np.asarray(diffs),
            }
        infos.append(info)
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return infos


def create_waymo_infos(raw_dir, out_dir, split_file, workers: int = 8):
    """All sequences of a split -> waymo_infos_<split>.pkl."""
    from concurrent.futures import ThreadPoolExecutor

    seqs = Path(split_file).read_text().split()
    paths = []
    for s in seqs:
        # real Waymo archives ship as <segment>_with_camera_labels.tfrecord
        for cand in (Path(raw_dir) / f"{s}.tfrecord",
                     Path(raw_dir) / f"{s}_with_camera_labels.tfrecord"):
            if cand.exists():
                paths.append(cand)
                break
        else:
            raise FileNotFoundError(f"no tfrecord for sequence {s!r} "
                                    f"in {raw_dir}")
    with ThreadPoolExecutor(workers) as pool:
        all_infos = list(pool.map(
            lambda p: process_single_sequence(p, out_dir), paths))
    flat = [i for infos in all_infos for i in infos]
    split = Path(split_file).stem
    with open(Path(out_dir).parent / f"waymo_infos_{split}.pkl", "wb") as f:
        pickle.dump(flat, f)
    return flat


def create_gt_database(infos, points_root, out_path,
                       class_names=("Vehicle", "Pedestrian", "Cyclist"),
                       frame_stride={"Vehicle": 4, "Pedestrian": 2,
                                     "Cyclist": 1}):
    """GT sampling database with per-class frame subsampling (reference
    waymo_preprocess.py:153-196). Pure NumPy — runs anywhere."""
    db = {c: [] for c in class_names}
    for fi, info in enumerate(infos):
        annos = info.get("annos")
        if annos is None:
            continue
        seq = info["point_cloud"]["lidar_sequence"]
        idx = info["point_cloud"]["sample_idx"]
        pts = np.load(Path(points_root) / seq / f"{idx:04d}.npy")
        for name, box in zip(annos["name"], annos["gt_boxes_lidar"]):
            if name not in class_names:
                continue
            if fi % frame_stride.get(name, 1) != 0:
                continue
            m = box_np.points_in_rotated_box(pts, box)
            obj = pts[m].copy()
            obj[:, :3] -= box[:3]  # store box-relative
            db[name].append({"box": box, "points": obj,
                             "sequence_name": seq, "sample_idx": idx})
    with open(out_path, "wb") as f:
        pickle.dump(db, f)
    return db

"""Inputs of the data-path tests (numpy only): a small Waymo-layout tree, its
dataset config, an in-memory GT database, and the four training
augmentors, at the tiny geometry of tests/test_torch_train_step.py
(pc_range +-6.4 m x -2..2 m, 0.2 x 0.2 x 0.5 m voxels, 2048 points,
8 GT slots)."""

from __future__ import annotations

import pickle

import numpy as np

PC_RANGE = [-6.4, -6.4, -2.0, 6.4, 6.4, 2.0]
VOXEL_SIZE = [0.2, 0.2, 0.5]
CLASS_NAMES = ["Vehicle", "Pedestrian", "Cyclist"]
FEATURES = ["x", "y", "z", "intensity", "elongation", "time_offset"]
SIZES = {"Vehicle": [4.5, 2.0, 1.6], "Pedestrian": [0.9, 0.9, 1.7],
         "Cyclist": [1.8, 0.8, 1.7]}


def augmentors(db_path=None):
    """The four augmentors of configs/det_dataset_cfgs/waymo_5sweeps.yaml,
    the GT sampler's targets cut to the tiny scene and seeded."""
    gt = {"NAME": "gt_sampling", "MIN_POINTS": 5, "SEED": 3,
          "SAMPLE_GROUPS": ["Vehicle:3", "Pedestrian:3", "Cyclist:3"]}
    if db_path is not None:
        gt["DB_INFO_PATH"] = str(db_path)
    return [gt,
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
            {"NAME": "random_world_rotation",
             "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
            {"NAME": "random_world_scaling",
             "WORLD_SCALE_RANGE": [0.95, 1.05]}]


def tree_cfg(root, sweeps=2):
    """A WaymoDetectionDataset config on the tree at `root` (the
    reference's native sweep loader off, so both packages read numpy)."""
    return {
        "DATASET": "WaymoDetectionDataset", "DATA_PATH": str(root),
        "POINT_CLOUD_RANGE": list(PC_RANGE), "SWEEP_COUNT": [1 - sweeps, 0],
        "NUM_POINT_BUDGET": 2048, "MAX_OBJS": 8,
        "DATA_SPLIT": {"train": "train", "test": "train"},
        "USE_NATIVE_LOADER": False, "CLASS_NAMES": list(CLASS_NAMES),
        "POINT_FEATURE_ENCODING": {"used_feature_list": list(FEATURES),
                                   "src_feature_list": list(FEATURES)},
        "DATA_AUGMENTOR": {"AUG_CONFIG_LIST": augmentors()},
        "DATA_PROCESSOR": [
            {"NAME": "mask_points_and_boxes_outside_range",
             "REMOVE_OUTSIDE_BOXES": True},
            {"NAME": "shuffle_points"},
            {"NAME": "transform_points_to_voxels_placeholder",
             "VOXEL_SIZE": list(VOXEL_SIZE)}],
    }


def gt_database(seed=5, per_class=6):
    """{class: [{box, points, ...}]}: boxes inside the tiny range with
    their surface points, 6 columns (time offset 0)."""
    rng = np.random.RandomState(seed)
    db = {}
    for name in CLASS_NAMES:
        db[name] = []
        for _ in range(per_class):
            size = np.array(SIZES[name]) * rng.uniform(0.8, 1.2, 3)
            box = np.array([*rng.uniform(-5, 5, 2), rng.uniform(-1, 0),
                            *size, rng.uniform(-np.pi, np.pi)], np.float32)
            local = rng.uniform(-0.5, 0.5, (rng.randint(3, 30), 3)) * box[3:6]
            c, s = np.cos(box[6]), np.sin(box[6])
            pts = np.zeros((len(local), 6), np.float32)
            pts[:, 0] = local[:, 0] * c - local[:, 1] * s + box[0]
            pts[:, 1] = local[:, 0] * s + local[:, 1] * c + box[1]
            pts[:, 2] = local[:, 2] + box[2]
            pts[:, 3:5] = rng.rand(len(local), 2)
            db[name].append({"name": name, "box": box, "points": pts,
                             "num_points_in_gt": len(pts)})
    return db


def write_tree(root, n_frames=3, n_points=2000, n_objects=5, seed=0):
    """One sequence of n_frames frames under `root`: <seq>/NNNN.npy (x, y,
    z, intensity, elongation, NLZ: -1, or 3 for a tenth of the points),
    poses that move 0.5 m and turn 0.02 rad a frame, and
    waymo_infos_train.pkl with 9-wide GT boxes (velocities included) and
    a name each, classes in turn."""
    rng = np.random.RandomState(seed)
    seq = "segment-tiny_000"
    (root / "waymo_processed_data" / seq).mkdir(parents=True)
    infos = []
    for f in range(n_frames):
        pts = np.zeros((n_points, 6), np.float32)
        pts[:, :2] = rng.uniform(-7, 7, (n_points, 2))
        pts[:, 2] = rng.uniform(-2.2, 2.2, n_points)
        pts[:, 3] = rng.rand(n_points) * 3
        pts[:, 4] = rng.rand(n_points)
        pts[:, 5] = np.where(rng.rand(n_points) < 0.1, 3.0, -1.0)
        np.save(root / "waymo_processed_data" / seq / f"{f:04d}.npy", pts)
        pose = np.eye(4, dtype=np.float32)
        a = 0.02 * f
        pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        pose[0, 3] = 0.5 * f
        names = np.array([CLASS_NAMES[i % 3] for i in range(n_objects)])
        boxes = np.zeros((n_objects, 9), np.float32)
        boxes[:, :2] = rng.uniform(-5.5, 5.5, (n_objects, 2))
        boxes[:, 2] = rng.uniform(-1, 1, n_objects)
        boxes[:, 3:6] = [SIZES[n] for n in names] * rng.uniform(
            0.8, 1.2, (n_objects, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_objects)
        boxes[:, 7:9] = rng.uniform(-5, 5, (n_objects, 2))
        infos.append({"point_cloud": {"lidar_sequence": seq,
                                      "sample_idx": f},
                      "pose": pose,
                      "annos": {"name": names, "gt_boxes_lidar": boxes}})
    with open(root / "waymo_infos_train.pkl", "wb") as fh:
        pickle.dump(infos, fh)
    return root

"""Test-time augmentation fan-out + inversion (port of detzero_tpu/data/tta.py).

Reference (augmentor/test_time_augmentor.py:9 + centerpoint.py:131
test_time_augment): one sample fans out into ~14 copies (original, flips,
yaw rotations, global scales); after inference each copy's boxes/velocities
are transformed back to the original frame and fused with WBF.
"""

from __future__ import annotations

import numpy as np

DEFAULT_TTA = (
    ["flip_x", "flip_y", "flip_xy"]
    + [f"rot_{a}" for a in (0.39269908, -0.39269908, 0.78539816, -0.78539816,
                            1.17809724, -1.17809724, 2.74889357, -2.74889357,
                            3.14159265)]
    + ["scale_0.95", "scale_1.05"]
)


def _apply(points, name):
    pts = points.copy()
    if name == "original":
        return pts
    if name.startswith("flip"):
        if "x" in name.split("_")[1]:
            pts[:, 1] = -pts[:, 1]
        if "y" in name.split("_")[1]:
            pts[:, 0] = -pts[:, 0]
        return pts
    if name.startswith("rot"):
        a = float(name.split("_")[1])
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s], [s, c]])
        pts[:, :2] = pts[:, :2] @ rot.T
        return pts
    if name.startswith("scale"):
        pts[:, :3] *= float(name.split("_")[1])
        return pts
    raise KeyError(name)


def invert_boxes(boxes, name):
    """Undo one TTA transform on (N, 7[+2]) boxes incl. velocity
    (reference centerpoint.py:162-202)."""
    b = np.array(boxes, float)
    if name == "original" or not len(b):
        return b
    if name.startswith("flip"):
        ax = name.split("_")[1]
        if "x" in ax:
            b[:, 1] = -b[:, 1]
            b[:, 6] = -b[:, 6]
            if b.shape[1] > 8:
                b[:, 8] = -b[:, 8]
        if "y" in ax:
            b[:, 0] = -b[:, 0]
            b[:, 6] = np.pi - b[:, 6]
            if b.shape[1] > 7:
                b[:, 7] = -b[:, 7]
        return b
    if name.startswith("rot"):
        a = -float(name.split("_")[1])
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s], [s, c]])
        b[:, :2] = b[:, :2] @ rot.T
        b[:, 6] += a
        if b.shape[1] > 8:
            b[:, 7:9] = b[:, 7:9] @ rot.T
        return b
    if name.startswith("scale"):
        s = float(name.split("_")[1])
        b[:, :6] /= s
        if b.shape[1] > 8:
            b[:, 7:9] /= s
        return b
    raise KeyError(name)


class TestTimeAugmentor:
    def __init__(self, cfg=None):
        names = (cfg or {}).get("TTA_LIST", DEFAULT_TTA)
        self.names = ["original"] + [n for n in names if n != "original"]

    def __call__(self, data):
        outs = []
        for name in self.names:
            d = dict(data)
            d["points"] = _apply(np.asarray(data["points"], np.float32), name)
            d["tta_name"] = name
            outs.append(d)
        return outs

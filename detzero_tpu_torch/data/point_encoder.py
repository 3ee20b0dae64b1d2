"""Point feature encoding (port of detzero_tpu/data/point_encoder.py;
reference PointFeatureEncoder,
processor/point_feature_encoder.py:6): select/derive the per-point feature
channels used by the model from the raw columns
[x, y, z, intensity, elongation, (nlz), (time_offset)]."""

from __future__ import annotations

import numpy as np


class PointFeatureEncoder:
    def __init__(self, used_features=("x", "y", "z", "intensity", "elongation",
                                      "time_offset"),
                 src_features=("x", "y", "z", "intensity", "elongation",
                               "time_offset")):
        self.used = list(used_features)
        self.src = list(src_features)

    @property
    def num_point_features(self):
        return len(self.used)

    def __call__(self, points):
        """points (N, len(src)) -> (N, len(used)): absolute-coordinate
        encoding (point_feature_encoder.py:47)."""
        cols = [self.src.index(f) for f in self.used]
        return np.ascontiguousarray(points[:, cols])


class PolarPointFeatureEncoder(PointFeatureEncoder):
    """Polar encoding variant (point_feature_encoder.py:36): xyz replaced by
    (rho, phi, z); remaining channels selected as usual."""

    def __call__(self, points):
        out = super().__call__(points)
        out[:, :3] = cart2cylinder(points)
        return out


def cart2cylinder(points):
    """xyz -> (rho, phi, z) (common_utils.py:189)."""
    rho = np.linalg.norm(points[:, :2], axis=1)
    phi = np.arctan2(points[:, 1], points[:, 0])
    return np.stack([rho, phi, points[:, 2]], axis=1)

"""Misc host utilities (port of detzero_tpu/utils/common.py, the same
functions computing the same bits; reference common_utils): the
multi_processing pool map, circle NMS, point and box helpers."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from detzero_tpu_torch.ops import box_np


def multi_processing(fn, items, workers: int = 8, chunk: int = 1):
    """ProcessPool map preserving order (common_utils.py:287-305); the
    workers are spawned, not forked, since the caller may hold threads
    (torch's, a loader's)."""
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(fn, items, chunksize=chunk))


def circle_nms(centers_xy, scores, radius: float, post_max: int | None = None):
    """Center-distance NMS (reference numba circle_nms,
    centernet_utils.py:82): greedy suppression of any box whose center lies
    within `radius` of a kept higher-score box. Pure NumPy."""
    order = np.argsort(-np.asarray(scores))
    centers = np.asarray(centers_xy, float)[order]
    keep = []
    r2 = radius * radius
    for i in range(len(centers)):
        ok = True
        for j in keep:
            d = centers[i] - centers[j]
            if d[0] * d[0] + d[1] * d[1] < r2:
                ok = False
                break
        if ok:
            keep.append(i)
            if post_max is not None and len(keep) >= post_max:
                break
    return order[np.asarray(keep, int)]


def remove_points_in_boxes3d(points, boxes3d):
    """Drop points inside any of the boxes (box_utils.py:75)."""
    pts = np.asarray(points)
    keep = np.ones(len(pts), bool)
    for b in np.asarray(boxes3d, float).reshape(-1, 7):
        keep &= ~box_np.points_in_rotated_box(pts, b)
    return pts[keep]


def drop_info_with_name(info: dict, name: str = "unknown"):
    """Filter annotation dicts by class name (OpenPCDet-style helper)."""
    keep = np.asarray(info["name"]) != name
    return {k: (np.asarray(v)[keep] if isinstance(v, (list, np.ndarray))
                and len(np.asarray(v)) == len(keep) else v)
            for k, v in info.items()}

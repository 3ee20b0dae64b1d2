"""detzero_tpu_torch.ops.box_np against detzero_tpu.ops.box_np: every
function, public and private, bit for bit (NaN where the reference gives
NaN) on seeded boxes that include identical pairs, degenerate boxes (zero
and 1e-6 sides) and the adversarial families of tests/torch_iou_cases.py."""

import numpy as np
import pytest

from detzero_tpu.ops import box_np as ref
from detzero_tpu_torch.ops import box_np

from torch_iou_cases import FAMILIES, pair_set


def boxes7(n, seed):
    """(n, 7) boxes: centres in +-4 m, sizes 0.3-5 m, headings in +-2 pi;
    the second half copies the first (identical pairs), and one box each
    has a zero side, two 1e-6 sides and zero height."""
    rng = np.random.RandomState(seed)
    b = np.concatenate([rng.uniform(-4, 4, (n, 3)),
                        rng.uniform(0.3, 5, (n, 3)),
                        rng.uniform(-2 * np.pi, 2 * np.pi, (n, 1))], 1)
    b[n // 2:] = b[:n - n // 2]
    b[1, 3] = 0.0
    b[2, 3:5] = 1e-6
    b[3, 5] = 0.0
    return b.astype(np.float32)


A = boxes7(12, 0)
B = np.concatenate([boxes7(10, 1), A[:4]])          # shares boxes with A
BEV_A, BEV_B = ref.boxes3d_to_bev(A), ref.boxes3d_to_bev(B)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


PAIRWISE = ["boxes_overlap_bev_vec", "boxes_overlap_bev",
            "boxes_iou_bev_vec", "boxes_iou_bev"]


@pytest.mark.parametrize("name", PAIRWISE)
def test_bev_matrices(name):
    assert same(getattr(ref, name)(BEV_A, BEV_B),
                getattr(box_np, name)(BEV_A, BEV_B))


@pytest.mark.parametrize("family", FAMILIES)
def test_bev_matrices_adversarial(family):
    # the first 48 of each set: the oracle clips pair by pair in Python
    a, b = (np.asarray(x[:48], np.float64) for x in pair_set(family))
    for name in PAIRWISE:
        assert same(getattr(ref, name)(a, b), getattr(box_np, name)(a, b)), \
            name


@pytest.mark.parametrize("name", ["height_overlap", "boxes_iou3d",
                                  "boxes_giou3d"])
def test_3d_matrices(name):
    got = getattr(box_np, name)(A, B)
    assert same(getattr(ref, name)(A, B), got)
    if name != "height_overlap":        # identical boxes: IoU 1 or the
        # reference's degenerate value, the same in both
        assert np.isfinite(got).all()


@pytest.mark.parametrize("i,j", [(0, 0), (0, 12), (1, 2), (4, 9), (2, 2)])
def test_pair_geometry(i, j):
    """The per-pair helpers: overlap, hull, corners, the clip and areas."""
    a, b = BEV_A[i], BEV_B[j]
    for name in ("rotated_overlap_bev", "rotated_union_hull_bev"):
        assert getattr(ref, name)(a, b) == getattr(box_np, name)(a, b), name
    corners = ref.boxes_to_corners_bev(np.stack([a, b]))
    assert same(corners, box_np.boxes_to_corners_bev(np.stack([a, b])))
    assert ref._convex_hull_area(corners.reshape(-1, 2)) == \
        box_np._convex_hull_area(corners.reshape(-1, 2))
    poly = [tuple(p) for p in corners[0]]
    e = corners[1, 1] - corners[1, 0]
    clip = (poly, *corners[1, 0], e[1], -e[0])
    assert ref._polygon_clip(*clip) == box_np._polygon_clip(*clip)
    assert ref._polygon_area(poly) == box_np._polygon_area(poly)
    assert ref._polygon_area(poly[:2]) == box_np._polygon_area(poly[:2])


def test_points_and_periods():
    rng = np.random.RandomState(3)
    pts = rng.uniform(-5, 5, (4000, 5)).astype(np.float32)
    for box in A:
        assert same(ref.points_in_rotated_box(pts, box),
                    box_np.points_in_rotated_box(pts, box))
    for angle in (0.0, 0.3, -2.5, np.float32(7.1)):
        assert same(ref.rotate_points_along_z(pts, angle),
                    box_np.rotate_points_along_z(pts, angle))
    val = rng.uniform(-20, 20, 100)
    for kw in ({}, {"offset": 0.0}, {"offset": 1.0, "period": 2 * np.pi}):
        assert same(ref.limit_period(val, **kw),
                    box_np.limit_period(val, **kw))
    assert same(ref.boxes3d_to_bev(A), box_np.boxes3d_to_bev(A))


def test_empty_inputs():
    e = np.zeros((0, 5))
    assert same(ref.boxes_overlap_bev_vec(e, BEV_B),
                box_np.boxes_overlap_bev_vec(e, BEV_B))
    assert same(ref.boxes_iou_bev(BEV_A, e), box_np.boxes_iou_bev(BEV_A, e))

"""The tail of the port's ops library against detzero_tpu on the CPU, on
seeded inputs that include zero-size boxes and boxes turned by pi/4:
`ops/box_ops.py` (rotation, BEV corners, enlarge and scale, points in
boxes, the range mask, pose transforms and inverse, voxel centres),
`ops/iou3d.py` (the union hull, the BEV IoU, the 3D GIoU, the axis-aligned
IoUs), `ops/box_coder.py` (PreviousResidualDecoder, PointResidualCoder)
and `ops/losses.py` (`gather_feat`, `sigmoid_focal_cls_loss`,
`weighted_smooth_l1` with weights).  Each test states its tolerance."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.ops import box_coder as jbc
from detzero_tpu.ops import box_ops as jbo
from detzero_tpu.ops import iou3d as jiou
from detzero_tpu.ops import losses as jl
from detzero_tpu_torch.ops import box_coder, box_ops, iou3d, iou_bev, losses

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def boxes7(seed, n, extent=6.0):
    """n boxes (n, 7): random, then a zero-size box, a box turned by pi/4,
    a copy of box 0 and a box nested in box 1."""
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-extent, extent, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-math.pi, math.pi, n)
    b[-4, 3:6] = 0.0                              # zero size
    b[-3, 6] = math.pi / 4                        # turned by pi/4
    b[-2] = b[0]                                  # identical to box 0
    b[-1] = b[1]                                  # nested in box 1
    b[-1, 3:6] *= 0.5
    return b


def close(got, want, rtol, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype or got.dtype.kind == want.dtype.kind
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------- box_ops

@pytest.mark.parametrize("name", ["rotation_matrix_2d", "boxes_to_corners_bev",
                                  "enlarge_box3d", "scale_box3d",
                                  "points_in_boxes",
                                  "mask_boxes_outside_range",
                                  "transform_boxes3d", "inverse_pose",
                                  "get_voxel_centers"])
def test_box_ops(name):
    """float32 within 1e-6 relative and 1e-5 absolute (trigonometry and
    products at scene scale); masks exact."""
    b = boxes7(0, 24)
    rng = np.random.RandomState(1)
    yaw = 0.3
    pose = np.eye(4, dtype=np.float32)
    pose[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                    [math.sin(yaw), math.cos(yaw)]]
    pose[:3, 3] = [10.0, -4.0, 1.5]
    b9 = np.concatenate([b, rng.randn(len(b), 2).astype(np.float32)], 1)
    b10 = np.concatenate([b9, rng.randn(len(b), 1).astype(np.float32)], 1)
    cases = {
        "rotation_matrix_2d": [(b[:, 6],)],
        "boxes_to_corners_bev": [(b[:, [0, 1, 3, 4, 6]],)],
        "enlarge_box3d": [(b, (0.5, 0.25, 1.0)), (b9, (1.0, 0.0, 0.0))],
        "scale_box3d": [(b, 1.5), (b9, 0.0)],
        "points_in_boxes": [(rng.uniform(-8, 8, (300, 4)).astype(np.float32),
                             b)],
        "mask_boxes_outside_range": [(b, (-4.0, -4.0, -2.0, 4.0, 4.0, 2.0)),
                                     (b, (-4.0, -4.0, -2.0, 4.0, 4.0, 2.0),
                                      4)],
        "transform_boxes3d": [(b, pose), (b9, pose), (b10, pose)],
        "inverse_pose": [(pose,)],
        "get_voxel_centers": [(rng.randint(0, 40, (50, 3)).astype(np.int32),
                               4, (0.1, 0.1, 0.15),
                               (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0))],
    }
    for args in cases[name]:
        want = np.asarray(getattr(jbo, name)(
            *[_j(a) if isinstance(a, np.ndarray) else a for a in args]))
        got = getattr(box_ops, name)(
            *[_t(a) if isinstance(a, np.ndarray) else a for a in args])
        if want.dtype == bool:
            assert np.array_equal(got.numpy(), want)
        else:
            close(got, want, 1e-6, 1e-5)
    if name == "points_in_boxes":
        assert 0 < want.sum() < want.size
    if name == "mask_boxes_outside_range":
        assert 0 < want.sum() < want.size


# ------------------------------------------------------------------ iou3d

def pair_sets():
    """A (18, 7) and B (28, 7): B is A followed by 10 other boxes, so that
    one pair of shapes (one compile of the reference's clip) serves every
    test of the rotated overlap."""
    a = boxes7(6, 18)
    return a, np.concatenate([a, boxes7(7, 10)])


def test_union_hull():
    """The union hull against the reference's Jarvis march, within 1e-5
    relative and 1e-4 absolute (areas of up to ~60 m^2 from float32
    corners), on the boxes (zero-size, pi/4, identical, nested) against
    themselves and others; the hull of a box with itself is the box, of a
    zero-size box with itself 0."""
    a, bb = (x[:, [0, 1, 3, 4, 6]] for x in pair_sets())
    want = np.asarray(jax.jit(jiou.boxes_union_hull_bev)(_j(a), _j(bb)))
    got = iou3d.boxes_union_hull_bev(_t(a), _t(bb))
    close(got, want, 1e-5, 1e-4)
    diag = np.diagonal(got.numpy()[:, :len(a)])
    np.testing.assert_allclose(diag, a[:, 2] * a[:, 3], rtol=1e-5,
                               atol=1e-4)
    assert diag[-4] == 0.0


def test_union_hull_chunks(monkeypatch):
    """The hull in chunks of pairs equals it in one piece, bit for bit."""
    a = _t(boxes7(4, 30)[:, [0, 1, 3, 4, 6]])
    whole = iou3d.boxes_union_hull_bev(a, a)
    monkeypatch.setattr(iou3d, "_HULL_CHUNK", 64)
    assert torch.equal(iou3d.boxes_union_hull_bev(a, a), whole)


def test_boxes_iou_bev_is_k3():
    """iou3d.boxes_iou_bev is K3's wrapper (its plain version on the CPU),
    bit-equal to the reference's ov / max(a + b - ov, 1e-6) on K7's plain
    overlap, and within 1e-5 of the reference's XLA clip away from the
    zero-size box: there the clip keeps all of the other box (the point's
    edges have no direction), the IoU is its area over the 1e-6 union
    clamp, and the reference's Pallas and XLA clips differ in millions
    (tests/test_torch_nms_vfe_redesign.py); K3 follows the Pallas one."""
    assert iou3d.boxes_iou_bev is iou_bev.boxes_iou_bev
    a, bb = (x[:, [0, 1, 3, 4, 6]] for x in pair_sets())
    ta, tb = _t(a), _t(bb)
    got = iou3d.boxes_iou_bev(ta, tb)
    ov = iou_bev.boxes_overlap_bev(ta, tb)
    sa, sb = ta[:, 2] * ta[:, 3], tb[:, 2] * tb[:, 3]
    assert torch.equal(got, ov / torch.clamp(sa[:, None] + sb[None, :] - ov,
                                             min=1e-6))
    want = np.asarray(jax.jit(jiou.boxes_iou_bev)(_j(a), _j(bb)))
    la, lb = a[:, 2] * a[:, 3] > 0, bb[:, 2] * bb[:, 3] > 0
    assert la.sum() == len(a) - 1 and lb.sum() == len(bb) - 2
    close(got[la][:, lb], want[la][:, lb], 0, 1e-5)


def test_giou3d():
    """boxes_giou3d (K7's plain version on the CPU, the hull in torch)
    against the reference's (its vmapped XLA clip, its Jarvis march), the
    union height min(amax, bmax) - min(amin, bmin) kept: within 1e-4
    absolute; the GIoU of a box of volume with itself 1."""
    a, bb = pair_sets()
    want = np.asarray(jax.jit(jiou.boxes_giou3d)(_j(a), _j(bb)))
    got = iou3d.boxes_giou3d(_t(a), _t(bb))
    close(got, want, 0, 1e-4)
    live = np.prod(a[:, 3:6], 1) > 0
    d = np.diagonal(got.numpy()[:, :len(a)])
    np.testing.assert_allclose(d[live], 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["boxes_iou_normal",
                                  "boxes3d_lidar_to_aligned_bev_boxes",
                                  "boxes3d_nearest_bev_iou"])
def test_aligned_ious(name):
    """Exact arithmetic of the reference in float32: within 1e-6 relative
    and 1e-6 absolute."""
    a, bb = boxes7(8, 16), boxes7(9, 9)
    a[:3, 6] = [math.pi / 4 - 1e-3, math.pi / 4 + 1e-3, 3 * math.pi / 4]
    args = (a,) if name == "boxes3d_lidar_to_aligned_bev_boxes" else (a, bb)
    want = np.asarray(getattr(jiou, name)(*map(_j, args)))
    got = getattr(iou3d, name)(*map(_t, args))
    close(got, want, 1e-6, 1e-6)


# -------------------------------------------------------------- box_coder

def test_previous_residual_decoder():
    """Within 1e-6 relative, 1e-5 absolute."""
    rng = np.random.RandomState(10)
    anchors = boxes7(10, 20)
    anchors[-4, 3:6] = 0.0          # clamped to 1e-5 on both sides
    deltas = rng.randn(20, 7).astype(np.float32) * 2
    want = np.asarray(jbc.PreviousResidualDecoder.decode(_j(deltas),
                                                         _j(anchors)))
    got = box_coder.PreviousResidualDecoder.decode(_t(deltas), _t(anchors))
    close(got, want, 1e-6, 1e-5)
    assert box_coder.PreviousResidualDecoder.code_size == 7


@pytest.mark.parametrize("classes,use_mean", [(True, True), (False, True),
                                              (True, False)])
def test_point_residual_coder(classes, use_mean):
    """encode and decode against the reference's, within 1e-5 relative and
    1e-5 absolute, log sizes clipped at +-4 on decode; decode(encode(b))
    gives b back (heading wrapped)."""
    rng = np.random.RandomState(11)
    mean = np.array([[4.6, 2.0, 1.6], [0.9, 0.85, 1.7], [1.8, 0.85, 1.7]],
                    np.float32)
    boxes = boxes7(11, 20)
    boxes[-4, 3:6] = 0.0
    pts = boxes[:, :3] + rng.randn(20, 3).astype(np.float32) * 0.5
    cls = rng.randint(0, 3, 20) if classes else None
    jc = jbc.PointResidualCoder(_j(mean), use_mean_size=use_mean)
    tc = box_coder.PointResidualCoder(_t(mean), use_mean_size=use_mean)
    jcls = None if cls is None else _j(cls)
    tcls = None if cls is None else _t(cls)
    enc = tc.encode(_t(boxes), _t(pts), tcls)
    close(enc, np.asarray(jc.encode(_j(boxes), _j(pts), jcls)), 1e-5, 1e-5)
    deltas = rng.randn(20, 8).astype(np.float32) * 3
    close(tc.decode(_t(deltas), _t(pts), tcls),
          np.asarray(jc.decode(_j(deltas), _j(pts), jcls)), 1e-5, 1e-5)
    back = tc.decode(enc, _t(pts), tcls).numpy()
    live = np.arange(20) != 16
    np.testing.assert_allclose(back[live, :6], boxes[live, :6], rtol=1e-5,
                               atol=1e-4)
    assert tc.code_size == 8


# ----------------------------------------------------------------- losses

def test_gather_feat():
    """Exact: rows of the flattened map."""
    rng = np.random.RandomState(12)
    feat = rng.randn(64, 5).astype(np.float32)
    inds = rng.randint(0, 64, 17).astype(np.int32)
    want = np.asarray(jl.gather_feat(_j(feat), _j(inds)))
    assert np.array_equal(losses.gather_feat(_t(feat), _t(inds)).numpy(),
                          want)


@pytest.mark.parametrize("wshape", ["leading", "full"])
def test_sigmoid_focal_cls_loss(wshape):
    """Within 1e-6 relative, 1e-7 absolute."""
    rng = np.random.RandomState(13)
    logits = (rng.randn(6, 30, 3) * 4).astype(np.float32)
    target = (rng.rand(6, 30, 3) > 0.7).astype(np.float32)
    w = rng.rand(*((6, 30) if wshape == "leading" else (6, 30, 3)))
    w = w.astype(np.float32)
    want = np.asarray(jl.sigmoid_focal_cls_loss(_j(logits), _j(target),
                                                _j(w)))
    got = losses.sigmoid_focal_cls_loss(_t(logits), _t(target), _t(w))
    close(got, want, 1e-6, 1e-7)


@pytest.mark.parametrize("wshape", [None, "leading", "full"])
def test_weighted_smooth_l1(wshape):
    """The reference's argument order (pred, target, weights, beta): within
    1e-6 relative, 1e-7 absolute; two positional arguments keep the
    unweighted loss of the PDV head's call."""
    rng = np.random.RandomState(14)
    pred = rng.randn(5, 40, 7).astype(np.float32)
    tgt = pred + (rng.randn(5, 40, 7) * 0.2).astype(np.float32)
    w = None if wshape is None else rng.rand(
        *((5, 40) if wshape == "leading" else (5, 40, 7))).astype(np.float32)
    for beta in (1.0 / 9.0, 0.5):
        want = np.asarray(jl.weighted_smooth_l1(
            _j(pred), _j(tgt), None if w is None else _j(w), beta))
        got = losses.weighted_smooth_l1(_t(pred), _t(tgt),
                                        None if w is None else _t(w), beta)
        close(got, want, 1e-6, 1e-7)
    if w is None:
        close(losses.weighted_smooth_l1(_t(pred), _t(tgt)),
              np.asarray(jl.weighted_smooth_l1(_j(pred), _j(tgt))), 1e-6,
              1e-7)

"""The plain PyTorch version of each kernel of detzero_tpu_torch against the
JAX function it replaces (Pallas kernels in interpret mode, as the reference
tests run them on the CPU).  The CUDA kernels themselves are compared with
these plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.models.detection.backbone3d_pallas import (
    augment_plan_rowpad as jax_augment,
)
from detzero_tpu.models.detection.backbone3d_pillar import (
    build_pillar_plan as jax_plan,
)
from detzero_tpu.ops import box_coder as jbc
from detzero_tpu.ops import box_ops as jbo
from detzero_tpu.ops import iou3d, pallas_iou, nms as jnms
from detzero_tpu.ops import pallas_pillar as ppk
from detzero_tpu.ops import pillars as jp
from detzero_tpu_torch.ops import box_coder, box_ops, iou_bev, nms
from detzero_tpu_torch.ops.rowpad_conv import rowpad_conv_fused_plain
from detzero_tpu_torch.ops.stream_vfe import stream_rowpad_feats_plain

torch.set_num_threads(1)

GRID = (8, 64, 64)
VS = (0.2, 0.2, 0.5)
PCR = (-6.4, -6.4, -2.0, 6.4, 6.4, 2.0)
CAPS = (512, 256, 128, 64)
B = 128


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """The reference's stream and dense tables and rowpad plan of one cloud
    (2048 points; ~1000 occupied cells against a 512-pillar budget)."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-6, 6, (2048, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.8, 1.8, 2048)
    pv = np.ones(2048, bool)
    stream = jp.build_pillar_table(jnp.asarray(pts), jnp.asarray(pv), GRID,
                                   VS, PCR, 512, feats_mode="stream")
    dense = jp.build_pillar_table(jnp.asarray(pts), jnp.asarray(pv), GRID,
                                  VS, PCR, 512)
    plan = jax.jit(lambda tb: jax_augment(
        jax_plan(tb, GRID, CAPS, with_centroids=False,
                 with_gather_maps=False), GRID, B))(dense)
    return stream, dense, plan


# ---------------------------------------------------------------- K1

def test_stream_vfe_plain_parity(scene):
    stream, dense, plan = scene
    s = stream["stream"]
    nz, ny = GRID[0], GRID[1]
    ref = np.asarray(ppk.stream_rowpad_feats(
        s["payload"], s["meta"], s["wstart"], nz=nz, ny=ny, row_budget=B,
        interpret=True))
    # unpack the reference's (NQ*C, 128) lane tiles into the port's stream
    pay = np.asarray(s["payload"])
    meta = np.asarray(s["meta"])
    nq = meta.shape[0] // 2
    pay = pay.reshape(nq, -1, 128).transpose(0, 2, 1).reshape(nq * 128, -1)
    meta = meta.reshape(nq, 2, 128).transpose(0, 2, 1).reshape(nq * 128, 2)
    got = stream_rowpad_feats_plain(
        _t(pay[:2048]), _t(meta[:2048, 0]), _t(meta[:2048, 1]),
        _t(s["wstart"]), nz=nz, ny=ny, row_budget=B).numpy()
    scale = np.abs(ref).max()
    assert got.shape == ref.shape == (ny, nz * 5, B)
    assert np.abs(got - ref).max() <= 1e-5 * scale
    # and against the dense table gathered into the row-padded layout
    lvl0 = plan[0]
    dense_rp = np.asarray(jp.rowpad_gather(
        dense["feats"].reshape(512, -1), lvl0["rp_gidx"], lvl0["rp_gvalid"],
        lvl0["rp_slot"], lvl0["rp_keep"]))
    assert np.abs(got - dense_rp).max() <= 1e-5 * scale


# ---------------------------------------------------------------- K2

def _conv_case(plan, mode, residual, relu, seed, cin=16, cout=16):
    rng = np.random.RandomState(seed)
    lvl_out = 1 if mode == "down" else 0
    nz = GRID[0]
    onz = nz // 2 if mode == "down" else nz
    zm_in = np.asarray(plan[0]["rp_zmask"])
    zm_out = np.asarray(plan[lvl_out]["rp_zmask"])
    table = rng.randn(zm_in.shape[0], nz, cin, B).astype(np.float32)
    table = (table * zm_in[:, :, None, :]).reshape(zm_in.shape[0], -1, B)
    nbr = np.asarray(plan[0]["rp_down_nbr" if mode == "down" else "rp_nbr"])
    w = (rng.randn(27, cin, cout) / math.sqrt(27 * cin)).astype(np.float32)
    mean = rng.randn(cout).astype(np.float32) * 0.3
    var = rng.rand(cout).astype(np.float32) + 0.5
    gamma = rng.rand(cout).astype(np.float32) + 0.5
    beta = rng.randn(cout).astype(np.float32) * 0.1
    sc = gamma / np.sqrt(var + 1e-3)
    bi = beta - mean * sc
    res = None
    if residual:
        res = rng.randn(zm_out.shape[0], onz, cout, B).astype(np.float32)
        res = (res * zm_out[:, :, None, :]).reshape(zm_out.shape[0], -1, B)
    kw = dict(nz=nz, cin=cin, cout=cout, z_stride=2 if mode == "down" else 1,
              out_nz=onz, mode=mode, relu=relu)
    return table, nbr, w, sc, bi, zm_out, res, kw


CONV_CASES = [("subm", True, True), ("subm", False, True),
              ("down", False, True)]


@pytest.mark.parametrize("mode,residual,relu", CONV_CASES)
def test_rowpad_conv_plain_vs_pallas_bf16(scene, mode, residual, relu):
    """bf16 inputs against the Pallas kernel (interpret mode), tolerance
    2e-2 * max|ref| as tests/test_fused_eval.py uses."""
    table, nbr, w, sc, bi, zm, res, kw = _conv_case(scene[2], mode, residual,
                                                    relu, seed=1)
    ref = np.asarray(ppk.rowpad_conv_fused(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(nbr),
        ppk.weight_fwd(jnp.asarray(w), kw["cin"], kw["cout"]),
        jnp.asarray(sc), jnp.asarray(bi), jnp.asarray(zm),
        None if res is None else jnp.asarray(res, jnp.bfloat16),
        interpret=True, **kw), np.float32)
    bf = torch.bfloat16
    got = rowpad_conv_fused_plain(
        _t(table).to(bf), _t(nbr), _t(w), _t(sc), _t(bi), _t(zm),
        None if res is None else _t(res).to(bf), **kw)
    assert got.dtype == bf
    got = got.float().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("mode,residual,relu", CONV_CASES)
def test_rowpad_conv_plain_vs_reference_f32(scene, mode, residual, relu):
    """f32 against rowpad_conv_reference plus the folded BN epilogue."""
    table, nbr, w, sc, bi, zm, res, kw = _conv_case(scene[2], mode, residual,
                                                    relu, seed=2)
    acc = np.asarray(ppk.rowpad_conv_reference(
        jnp.asarray(table), jnp.asarray(nbr), jnp.asarray(w), nz=kw["nz"],
        cin=kw["cin"], cout=kw["cout"], z_stride=kw["z_stride"],
        out_nz=kw["out_nz"], mode=mode, dtype=jnp.float32))
    ny, _, b = acc.shape
    y = acc.reshape(ny, kw["out_nz"], kw["cout"], b) \
        * sc[None, None, :, None] + bi[None, None, :, None]
    if res is not None:
        y = y + res.reshape(y.shape)
    if relu:
        y = np.maximum(y, 0.0)
    ref = (y * zm[:, :, None, :]).reshape(acc.shape)
    got = rowpad_conv_fused_plain(
        _t(table), _t(nbr), _t(w), _t(sc), _t(bi), _t(zm),
        None if res is None else _t(res), **kw).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


# ---------------------------------------------------------------- K3

def _special_boxes():
    """Identical, touching, disjoint, 45- and 90-degree rotated pairs."""
    q = math.pi / 4
    return np.array([
        [0.0, 0.0, 4.0, 2.0, 0.0],
        [0.0, 0.0, 4.0, 2.0, 0.0],          # identical to 0
        [4.0, 0.0, 4.0, 2.0, 0.0],          # touches 0 along an edge
        [20.0, 20.0, 1.0, 1.0, 0.3],        # disjoint
        [0.0, 0.0, 4.0, 2.0, q],            # 0 rotated 45 degrees
        [0.0, 0.0, 4.0, 2.0, 2 * q],        # 0 rotated 90 degrees
        [0.5, 0.2, 2.0, 2.0, q],
        [30.0, -12.0, 4.5, 1.9, -2.0],
        [30.3, -12.1, 4.4, 2.0, -1.9],
    ], np.float32)


def _random_boxes(seed, n):
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-8, 8, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 5.0, (n, 2))
    b[:, 4] = rng.uniform(-math.pi, math.pi, n)
    return b


def test_iou_bev_plain_parity():
    boxes = np.concatenate([_special_boxes(), _random_boxes(0, 119)])
    got = iou_bev.boxes_iou_bev_plain(_t(boxes), _t(boxes)).numpy()
    ref_pallas = np.asarray(pallas_iou.boxes_iou_bev(jnp.asarray(boxes),
                                                     jnp.asarray(boxes)))
    ref_xla = np.asarray(iou3d.boxes_iou_bev(jnp.asarray(boxes),
                                             jnp.asarray(boxes)))
    assert np.abs(got - ref_pallas).max() <= 1e-5
    assert np.abs(got - ref_xla).max() <= 1e-5
    assert abs(got[0, 1] - 1.0) <= 1e-5 and got[0, 3] == 0.0
    assert abs(got[0, 2]) <= 1e-5
    assert got[0, 4] > 0 and got[0, 5] > 0
    # the wrapper takes the plain version on CPU tensors
    assert np.array_equal(iou_bev.boxes_iou_bev(_t(boxes), _t(boxes)).numpy(),
                          got)


@pytest.mark.parametrize("thresh", [0.1, 0.3, 0.7])
def test_nms_walk_plain_parity(thresh):
    boxes = _random_boxes(1, 256)
    iou = iou_bev.boxes_iou_bev_plain(_t(boxes), _t(boxes)).numpy()
    valid = np.random.RandomState(2).rand(256) > 0.2
    ref = np.asarray(jnms._greedy_suppress(jnp.asarray(iou),
                                           jnp.asarray(valid), thresh))
    got = nms.nms_walk_plain(_t(iou), _t(valid), thresh).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(nms.nms_walk(_t(iou), _t(valid), thresh).numpy(),
                          ref)


@pytest.mark.parametrize("n,pre_max,post_max", [(300, 256, 128),
                                                (40, 512, 128),
                                                (1500, 1024, 256)])
def test_nms_bev_parity(n, pre_max, post_max):
    rng = np.random.RandomState(n)
    b5 = _random_boxes(3 + n, n)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, [0, 1, 3, 4, 6]] = b5
    boxes[:, 2] = rng.uniform(-1, 1, n)
    boxes[:, 5] = rng.uniform(1, 2, n)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.3
    ji, jm = jnms.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), 0.2,
                          pre_max=pre_max, post_max=post_max,
                          valid_mask=jnp.asarray(valid))
    ti, tm = nms.nms_bev(_t(boxes), _t(scores), 0.2, pre_max=pre_max,
                         post_max=post_max, valid_mask=_t(valid))
    jm = np.asarray(jm)
    assert 0 < jm.sum() < valid.sum()
    assert np.array_equal(tm.numpy(), jm)
    assert np.array_equal(ti.numpy()[jm], np.asarray(ji)[jm])


# ---------------------------------------------------------------- box ops

def test_box_ops_and_coder_parity():
    rng = np.random.RandomState(4)
    boxes = rng.uniform(-3, 3, (50, 9)).astype(np.float32)
    boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 0.5
    anchors = rng.uniform(-3, 3, (50, 9)).astype(np.float32)
    anchors[:, 3:6] = np.abs(anchors[:, 3:6]) + 0.5
    assert np.array_equal(box_ops.boxes3d_to_bev(_t(boxes)).numpy(),
                          np.asarray(jbo.boxes3d_to_bev(jnp.asarray(boxes))))
    a = np.asarray(jbo.limit_period(jnp.asarray(boxes[:, 6] * 3)))
    b = box_ops.limit_period(_t(boxes[:, 6] * 3)).numpy()
    assert np.abs(a - b).max() <= 1e-5
    for sincos in (False, True):
        jc = jbc.ResidualCoder(7, encode_angle_by_sincos=sincos)
        tc = box_coder.ResidualCoder(7, encode_angle_by_sincos=sincos)
        enc_j = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
        enc_t = tc.encode(_t(boxes), _t(anchors)).numpy()
        assert np.abs(enc_j - enc_t).max() <= 1e-5
        dec_j = np.asarray(jc.decode(jnp.asarray(enc_j), jnp.asarray(anchors)))
        dec_t = tc.decode(_t(enc_j), _t(anchors)).numpy()
        assert np.abs(dec_j - dec_t).max() <= 1e-5

"""The plain PyTorch versions of the training kernels of detzero_tpu_torch
against the JAX functions they replace, on the CPU: K4 (`rowpad_conv`,
'subm', 'down', 'up') and K5 (`rowpad_conv_dw`) against the Pallas kernels
in interpret mode, K6 (matched-pair overlap and IoU) against
`pallas_iou._launch_pairwise` in interpret mode, and the `RowpadConv`
gradients against `jax.grad` through `pallas_pillar.make_conv_op`.  The CUDA
kernels are compared with these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.ops import iou3d as jiou3d
from detzero_tpu.ops import pallas_iou
from detzero_tpu.ops import pallas_pillar as ppk
from detzero_tpu_torch.ops import iou3d, iou_bev
from detzero_tpu_torch.ops.rowpad_conv import (
    RowpadConv, flip_weight, rowpad_conv, rowpad_conv_dw, rowpad_conv_plain,
)

from test_torch_kernels_cpu import (  # noqa: F401  (the scene fixture)
    B, GRID, _random_boxes, _special_boxes, _t, scene,
)

torch.set_num_threads(1)

NZ = GRID[0]


def _masked(rng, zm, c):
    """Random (ny, nz*c, B) table, zero where the level's zmask is empty."""
    x = rng.randn(zm.shape[0], zm.shape[1], c, B).astype(np.float32)
    return (x * zm[:, :, None, :]).reshape(zm.shape[0], -1, B)


def _case(plan, mode, seed, cin=16, cout=32):
    """Inputs of one conv of the tiny plan: the L0 subm conv, the L0 -> L1
    down conv, or the 'up' input-gradient conv of that down conv."""
    rng = np.random.RandomState(seed)
    zm0 = np.asarray(plan[0]["rp_zmask"])
    zm1 = np.asarray(plan[1]["rp_zmask"])
    w = (rng.randn(27, cin, cout) / math.sqrt(27 * cin)).astype(np.float32)
    if mode == "up":
        # d_out of the down conv, flowing back to L0
        table = _masked(rng, zm1, cout)
        nbr = np.asarray(plan[0]["rp_up_nbr"])
        return table, nbr, w, dict(nz=NZ, cin=cout, cout=cin, out_nz=NZ,
                                   mode="up")
    table = _masked(rng, zm0, cin)
    if mode == "down":
        return table, np.asarray(plan[0]["rp_down_nbr"]), w, dict(
            nz=NZ, cin=cin, cout=cout, z_stride=2, out_nz=NZ // 2,
            mode="down")
    return table, np.asarray(plan[0]["rp_nbr"]), w, dict(
        nz=NZ, cin=cin, cout=cout, mode="subm")


@pytest.mark.parametrize("mode", ["subm", "down", "up"])
def test_rowpad_conv_plain_vs_pallas_bf16(scene, mode):
    """K4 on bf16 inputs against the Pallas kernel (interpret mode), within
    2e-2 * max|ref| as the K2 test: the same bf16 inputs, f32 sums in
    another order, one bf16 rounding of the output."""
    table, nbr, w, kw = _case(scene[2], mode, seed=3)
    cin_f, cout_f = (kw["cout"], kw["cin"]) if mode == "up" \
        else (kw["cin"], kw["cout"])
    w_k = (ppk.weight_bwd if mode == "up" else ppk.weight_fwd)(
        jnp.asarray(w), cin_f, cout_f)
    ref = np.asarray(ppk.rowpad_conv(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(nbr), w_k,
        interpret=True, **kw), np.float32)
    w_port = flip_weight(_t(w), cin_f, cout_f) if mode == "up" else _t(w)
    got = rowpad_conv(_t(table).to(torch.bfloat16), _t(nbr), w_port, **kw)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_rowpad_conv_plain_zmask(scene):
    """With the output level's zmask the plain version zeroes the empty
    sites and leaves the occupied ones as they were."""
    table, nbr, w, kw = _case(scene[2], "down", seed=4)
    zm = _t(scene[2][1]["rp_zmask"])
    full = rowpad_conv_plain(_t(table), _t(nbr), _t(w), **kw)
    masked = rowpad_conv_plain(_t(table), _t(nbr), _t(w), zm, **kw)
    keep = zm[:, :, None, :].expand(-1, -1, kw["cout"], -1).reshape(
        full.shape)
    assert torch.equal(masked, torch.where(keep, full, 0.0))
    assert bool((full[~keep] != 0).any())


@pytest.mark.parametrize("mode", ["subm", "down"])
def test_rowpad_conv_dw_plain_vs_pallas(scene, mode):
    """K5 against the Pallas weight-gradient kernel (interpret mode): both
    sum the same bf16 products in f32, so 1e-4 * max|ref|."""
    table, nbr, w, kw = _case(scene[2], mode, seed=5)
    zm_out = np.asarray(scene[2][1 if mode == "down" else 0]["rp_zmask"])
    d_out = _masked(np.random.RandomState(6), zm_out, kw["cout"])
    cin, cout = kw["cin"], kw["cout"]
    ref = np.asarray(ppk.dw_to_spconv(ppk.rowpad_conv_dw(
        jnp.asarray(table), jnp.asarray(nbr),
        jnp.asarray(d_out, jnp.bfloat16), interpret=True, **kw), cin, cout))
    got = rowpad_conv_dw(_t(table), _t(nbr), _t(d_out), **kw).numpy()
    assert got.shape == ref.shape == (27, cin, cout)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    # skipping the sites the output zmask marks empty changes nothing: the
    # gradient there is zero
    masked = rowpad_conv_dw(_t(table), _t(nbr), _t(d_out), _t(zm_out),
                            **kw).numpy()
    assert np.array_equal(masked, got)


@pytest.mark.parametrize("mode", ["subm", "down"])
def test_rowpad_conv_grads_vs_jax(scene, mode):
    """RowpadConv's backward against jax.grad through make_conv_op's
    reference path (f32): d_table within 1e-3 * max|ref|, dW within
    1e-2 * max|ref| (the reference's CPU dW is rounded to bf16)."""
    plan = scene[2]
    table, nbr, w, kw = _case(plan, mode, seed=7)
    nbr_up = np.asarray(plan[0]["rp_up_nbr"])
    onz = kw.get("out_nz", NZ)
    ct = np.random.RandomState(8).randn(nbr.shape[0], onz * kw["cout"],
                                        B).astype(np.float32)
    conv = ppk.make_conv_op(nz=NZ, cin=kw["cin"], cout=kw["cout"],
                            z_stride=kw.get("z_stride", 1), out_nz=onz,
                            mode=mode, use_pallas=False, dtype=jnp.float32)

    def loss(t, wt):
        out = conv(t, wt, jnp.asarray(nbr), jnp.asarray(nbr_up))
        return (out * jnp.asarray(ct)).sum()

    ref_t, ref_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table),
                                                  jnp.asarray(w))
    t_ = _t(table).requires_grad_()
    w_ = _t(w).requires_grad_()
    out = RowpadConv.apply(t_, w_, _t(nbr), _t(nbr_up), None, None, NZ,
                           kw["cin"], kw["cout"], kw.get("z_stride", 1), onz,
                           mode)
    (out * _t(ct)).sum().backward()
    ref_t, ref_w = np.asarray(ref_t), np.asarray(ref_w)
    assert np.abs(t_.grad.numpy() - ref_t).max() <= 1e-3 * np.abs(ref_t).max()
    assert np.abs(w_.grad.numpy() - ref_w).max() <= 1e-2 * np.abs(ref_w).max()


def test_rowpad_conv_no_table_grad():
    """The stem's table needs no gradient: RowpadConv then computes dW only."""
    nbr = torch.full((4, 16, 8), 8, dtype=torch.int32)
    nbr[:, 4] = torch.arange(8)
    t = torch.randn(4, 2 * 3, 8)
    w = torch.randn(27, 3, 16, requires_grad=True)
    out = RowpadConv.apply(t, w, nbr, nbr, None, None, 2, 3, 16, 1, 2,
                           "subm")
    out.sum().backward()
    assert t.grad is None and w.grad is not None
    assert float(w.grad[13].abs().sum()) > 0   # the centre tap


# ---------------------------------------------------------------- K6

def _pairs():
    """Matched pairs: identical, touching, disjoint, rotated, and jittered
    near-duplicates, as the IoU branch's decoded-vs-target pairs are."""
    s = _special_boxes()
    a = s[[0, 0, 0, 0, 0, 6, 7, 3]]
    b = s[[1, 2, 3, 4, 5, 0, 8, 3]]
    r = _random_boxes(9, 120)
    jit = np.random.RandomState(10).randn(120, 5).astype(np.float32) \
        * np.array([0.4, 0.4, 0.3, 0.3, 0.2], np.float32)
    rb = r + jit
    rb[:, 2:4] = np.abs(rb[:, 2:4]) + 0.1
    return np.concatenate([a, r]), np.concatenate([b, rb])


@pytest.mark.parametrize("kind", ["overlap", "iou"])
def test_pairwise_plain_vs_pallas(kind):
    a, b = _pairs()
    ref = np.asarray(pallas_iou._launch_pairwise(
        jnp.asarray(a), jnp.asarray(b), kind, True))
    fn = iou_bev.boxes_iou_bev_pairwise if kind == "iou" \
        else iou_bev.boxes_overlap_bev_pairwise
    got = fn(_t(a), _t(b)).numpy()
    assert got.shape == ref.shape == (a.shape[0],)
    assert np.abs(got - ref).max() <= 1e-5
    if kind == "iou":
        assert abs(got[0] - 1.0) <= 1e-5 and got[2] == 0.0
        # the matrix kernel's diagonal on the same pairs
        full = iou_bev.boxes_iou_bev_plain(_t(a), _t(b)).numpy()
        assert np.abs(np.diag(full) - got).max() <= 1e-6
    assert iou_bev.PAIRWISE_LAUNCHES == 0


def test_iou3d_pairwise_vs_jax():
    a5, b5 = _pairs()
    rng = np.random.RandomState(11)

    def lift(b):
        out = np.zeros((b.shape[0], 7), np.float32)
        out[:, [0, 1, 3, 4, 6]] = b
        out[:, 2] = rng.uniform(-1, 1, b.shape[0])
        out[:, 5] = rng.uniform(1, 2, b.shape[0])
        return out

    a, b = lift(a5), lift(b5)
    ref = np.asarray(jiou3d.boxes_iou3d_pairwise(jnp.asarray(a),
                                                 jnp.asarray(b)))
    got = iou3d.boxes_iou3d_pairwise(_t(a), _t(b)).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    assert (got > 0.1).sum() > 50

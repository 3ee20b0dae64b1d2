"""The plain PyTorch versions of kernels K8 (`ops/rowpad_nbr.rowpad_nbr`, the
plan's neighbour-rank maps) and K9 (`rowpad_conv.rowpad_conv_sliding`, the
sliding-window 'subm' conv) against the Pallas kernels they replace in
interpret mode, and `RowpadConv` under `USE_SLIDING` against
`pallas_pillar.make_conv_op` with the reference's own switch on, under
`jax.vjp`.  The CUDA kernels are compared with these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.models.detection.backbone3d import plan_grids
from detzero_tpu.models.detection.backbone3d_pillar import (
    build_pillar_plan as jax_plan,
)
from detzero_tpu.ops import pallas_pillar as ppk
from detzero_tpu.ops import pillars as jp
from detzero_tpu_torch.ops import rowpad_conv, rowpad_nbr
from detzero_tpu_torch.ops.rowpad_conv import RowpadConv

from test_torch_kernels_cpu import B, GRID, _t, scene  # noqa: F401

torch.set_num_threads(1)

NZ = GRID[0]


@pytest.mark.parametrize("row_budget", [8, 128])
def test_rowpad_nbr_plain_vs_pallas(row_budget):
    """All 10 maps of a real tiny plan (tests/test_pallas_pillar.py's cloud):
    the port's K8 on CPU tensors equals `pallas_pillar.rowpad_nbr` on every
    element of all 16 rows.  Row budget 8 is far below the rows' occupancy,
    so rows keep only their first 8 pillars."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-6.4, 6.4, (2048, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 2, 2048)
    valid = rng.rand(2048) < 0.9
    table = jp.build_pillar_table(
        jnp.asarray(pts), jnp.asarray(valid), GRID, (0.2, 0.2, 0.5),
        (-6.4, -6.4, -2.0, 6.4, 6.4, 2.0), 512)
    plan = jax_plan(table, GRID, (512, 256, 128, 64), with_centroids=False,
                    with_gather_maps=False)
    xq = []
    for lvl, (_, ny, nx) in enumerate(plan_grids(GRID)[:4]):
        e = plan[lvl]
        lay = jp.rowpad_layout(e["cells"], e["mask"], (ny, nx), row_budget)
        xq.append(jp.rowpad_xcoords(e["coords2d"][:, 1], lay["gidx"],
                                    lay["gvalid"], ppk.NBR_BIG))
    cases = [(xq[lvl], xq[lvl], "subm") for lvl in range(4)]
    for lvl in range(3):
        cases += [(xq[lvl + 1], xq[lvl], "down"),
                  (xq[lvl], xq[lvl + 1], "up")]
    n_full = 0
    for q, x_in, mode in cases:
        ref = np.asarray(ppk.rowpad_nbr(q, x_in, mode=mode, interpret=True))
        got = rowpad_nbr.rowpad_nbr(_t(q), _t(x_in), mode=mode)
        assert got.dtype == torch.int32
        assert got.shape == ref.shape == (q.shape[0], 16, row_budget)
        assert np.array_equal(got.numpy(), ref), (mode, np.argwhere(
            got.numpy() != ref)[:5])
        n_full += int((ref[:, :9] < row_budget).sum())
        assert (ref[:, 9:] == row_budget).all()
    assert n_full > 0
    # full rows at budget 8: the overflow branch is exercised
    if row_budget == 8:
        assert (np.asarray(xq[0]) < ppk.NBR_BIG).all(1).any()
    assert rowpad_nbr.LAUNCHES == 0


def _subm_case(plan, seed, cin, cout):
    """A bf16-rounded table of L0 (zero at empty sites) and weight."""
    rng = np.random.RandomState(seed)
    zm = np.asarray(plan[0]["rp_zmask"])
    x = rng.randn(zm.shape[0], NZ, cin, B).astype(np.float32)
    table = (x * zm[:, :, None, :]).reshape(zm.shape[0], -1, B)
    w = (rng.randn(27, cin, cout) / math.sqrt(27 * cin)).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    return bf(table), bf(w), np.asarray(plan[0]["rp_nbr"]), zm


@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 32)])
def test_rowpad_conv_sliding_plain_vs_pallas(scene, cin, cout):
    """K9 on CPU tensors (K4's plain version in 'subm') against the Pallas
    sliding kernel in interpret mode on bf16-rounded inputs: within 1e-2 *
    max|ref|, the reference's bf16 output rounding."""
    table, w, nbr, _ = _subm_case(scene[2], 1, cin, cout)
    ref = np.asarray(ppk.rowpad_conv_sliding(
        jnp.asarray(table), jnp.asarray(nbr),
        ppk.weight_fwd(jnp.asarray(w), cin, cout), nz=NZ, cin=cin,
        cout=cout, interpret=True), np.float32)
    got = rowpad_conv.rowpad_conv_sliding(
        _t(table).to(torch.bfloat16), _t(nbr), _t(w), nz=NZ, cin=cin,
        cout=cout)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == ref.shape == (nbr.shape[0], NZ * cout, B)
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    assert rowpad_conv.SLIDING_LAUNCHES == 0


def test_sliding_conv_op_vs_make_conv_op(scene, monkeypatch):
    """`RowpadConv` with `rowpad_conv.USE_SLIDING` against
    `make_conv_op(mode="subm", use_pallas=True)` with
    `pallas_pillar.USE_SLIDING`, under `jax.vjp` (the sliding kernel
    forward, the halo kernel and the weight-gradient kernel backward, all in
    interpret mode): the output, d_table and dW each within 3e-2 of max|ref|,
    as tests/test_pallas_pillar.py holds K4 and K5.  The port's forward goes
    through `rowpad_conv_sliding` exactly once."""
    cin = cout = 16
    plan = scene[2]
    table, w, nbr, _ = _subm_case(plan, 2, cin, cout)
    ct = np.random.RandomState(3).randn(nbr.shape[0], NZ * cout,
                                        B).astype(np.float32)
    monkeypatch.setattr(ppk, "USE_SLIDING", True)
    conv = ppk.make_conv_op(nz=NZ, cin=cin, cout=cout, mode="subm",
                            use_pallas=True)
    out_ref, vjp = jax.vjp(lambda t, wt: conv(t, wt, jnp.asarray(nbr),
                                              jnp.asarray(nbr)),
                           jnp.asarray(table), jnp.asarray(w))
    dt_ref, dw_ref = vjp(jnp.asarray(ct, out_ref.dtype))

    calls = []
    sliding = rowpad_conv.rowpad_conv_sliding

    def counted(*a, **kw):
        calls.append(kw)
        return sliding(*a, **kw)

    monkeypatch.setattr(rowpad_conv, "USE_SLIDING", True)
    monkeypatch.setattr(rowpad_conv, "rowpad_conv_sliding", counted)
    t_ = _t(table).requires_grad_()
    w_ = _t(w).requires_grad_()
    out = RowpadConv.apply(t_, w_, _t(nbr), _t(nbr), None, None, NZ, cin,
                           cout, 1, NZ, "subm")
    (out * _t(ct)).sum().backward()
    assert len(calls) == 1
    for got, ref in ((out.detach(), out_ref), (t_.grad, dt_ref),
                     (w_.grad, dw_ref)):
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape
        assert np.abs(ref).max() > 0
        assert np.abs(got.numpy() - ref).max() <= 3e-2 * np.abs(ref).max()

"""The bookkeeping by which chip_smoke.py times and bounds the row-pad convs,
on the CPU:
  * every distinct conv of a frame (K2) and a training step (K4, K5) with
    its launches there, summing to the launch gates;
  * `conv_reads`, the (occupied output site, occupied input tap) pairs and
    the occupied input sites read, which the convs' bound counts, against
    a brute-force walk over the tiny plan;
  * K4's and K5's plain versions against the Pallas kernels (interpret
    mode) at the stem's cin 5, which the tensor-core kernels pad to 16."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from detzero_tpu.ops import pallas_pillar as ppk
from detzero_tpu_torch.ops import rowpad_conv as rc

from test_torch_kernels_cpu import _t, scene  # noqa: F401  (the fixture)
from test_torch_train_kernels import _case, _masked

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke")


@pytest.fixture(scope="module")
def tiny_plan(smoke):
    """The port's row-pad plan of the tiny cloud of chip_smoke's predict
    check, on the CPU."""
    pts, pv = smoke.entry_points(2048, seed=0)
    pts[..., :2] *= 6.0 / 70.0
    pts[..., 2] = np.clip(pts[..., 2], -1.8, 1.8)
    model = smoke.build_model(smoke.TINY_CFG, smoke.TINY_KW, torch.float32,
                              "cpu")
    return model.build_plan(model.build_table(torch.from_numpy(pts[0]),
                                              torch.from_numpy(pv[0])))


def test_conv_shapes_sum_to_the_launch_gates(smoke):
    """K2 20 launches a frame, K4 39 and K5 20 a step, each shape once."""
    for kernel, want in (("K2", 20), ("K4", 39), ("K5", 20)):
        shapes = smoke.conv_shapes(kernel, 5)
        assert sum(s[-1] for s in shapes) == want, kernel
        assert len({s[0] for s in shapes}) == len(shapes), kernel
    k4 = smoke.conv_shapes("K4", 5)
    assert sorted({s[1] for s in k4}) == ["down", "subm", "up"]
    assert [s[-1] for s in k4 if s[1] == "up"] == [1, 1, 1]
    assert {s[1] for s in smoke.conv_shapes("K5", 5)} == {"subm", "down"}
    assert sum(s[-1] for s in smoke.conv_shapes("K2", 5) if s[6]) == 8


def _brute_reads(nbr, zm_in, zm_out, nz, mode, z_stride):
    """conv_reads walked site by site: each occupied output site, each of
    its 27 taps whose neighbour exists, whose input plane exists and whose
    input site is occupied."""
    nbr, zm_in, zm_out = (np.asarray(a) for a in (nbr, zm_in, zm_out))
    ny_in, planes, b_in = zm_in.shape
    read, pairs = set(), 0
    for y, z, r in zip(*np.nonzero(zm_out)):
        for j in range(9):
            dy = j // 3 - 1
            src = {"subm": y + dy, "down": 2 * y + dy,
                   "up": (y + dy) // 2}[mode]
            src = min(max(src, 0), ny_in - 1)
            rank = int(nbr[y, j, r])
            if not 0 <= rank < b_in:
                continue
            for t in range(3):
                zi = z * z_stride + t - 1
                if not 0 <= zi < nz or (mode == "up" and zi % 2):
                    continue
                plane = zi // 2 if mode == "up" else zi
                if zm_in[src, plane, rank]:
                    pairs += 1
                    read.add((src, plane, rank))
    return len(read), pairs


@pytest.mark.parametrize("index", range(11))
def test_conv_reads_brute_force(smoke, tiny_plan, index):
    """The pairs and input sites of each distinct training conv on the tiny
    plan, counted by chip_smoke.conv_reads, equal a brute-force walk."""
    _, mode, lv_in, lv_out, *_ = smoke.conv_shapes("K4", 5)[index]
    nbr, zm_in, zm_out, nz, z_stride = smoke.conv_args(tiny_plan, mode,
                                                       lv_in, lv_out)
    got = smoke.conv_reads(nbr, zm_in, zm_out, nz, mode, z_stride)
    assert got == _brute_reads(nbr, zm_in, zm_out, nz, mode, z_stride)
    assert got[1] > 0


def test_conv_work_counts_occupied_reads(smoke, tiny_plan):
    """The bound's bytes: occupied input values read, the zmask, nine map
    rows and the dense output (conv), or the occupied output gradient and
    the f32 result (weight gradient)."""
    nbr, zm_in, zm_out, nz, zs = smoke.conv_args(tiny_plan, "subm", 0, 0)
    n_read, pairs = smoke.conv_reads(nbr, zm_in, zm_out, nz, "subm", zs)
    ny, onz, b = zm_out.shape
    maps = zm_out.numel() + 9 * ny * b * 4
    n_bytes, ops = smoke.conv_work(nbr, zm_in, zm_out, nz, 16, 32, "subm",
                                   zs)
    assert ops == 2.0 * 16 * 32 * pairs
    assert n_bytes == 2 * n_read * 16 + maps + 2 * 27 * 16 * 32 \
        + 2 * zm_out.numel() * 32
    n_occ = int(zm_out.sum())
    fused, _ = smoke.conv_work(nbr, zm_in, zm_out, nz, 16, 32, "subm", zs,
                               epilogue=True, residual=True)
    assert fused == n_bytes + 8 * 32 + 2 * n_occ * 32
    dw, _ = smoke.conv_work(nbr, zm_in, zm_out, nz, 16, 32, "subm", zs,
                            dw=True)
    assert dw == 2 * n_read * 16 + maps + 2 * n_occ * 32 + 4 * 27 * 16 * 32


@pytest.mark.parametrize("mode", ["subm", "down", "up"])
def test_rowpad_conv_plain_vs_pallas_cin5(scene, mode):  # noqa: F811
    """K4's plain version at the stem's 5 input channels ('up': 5 output
    channels) against the Pallas kernel in interpret mode, bf16 inputs,
    2e-2 * max|ref|."""
    table, nbr, w, kw = _case(scene[2], mode, seed=7, cin=5, cout=16)
    cin_f, cout_f = (kw["cout"], kw["cin"]) if mode == "up" \
        else (kw["cin"], kw["cout"])
    w_k = (ppk.weight_bwd if mode == "up" else ppk.weight_fwd)(
        jnp.asarray(w), cin_f, cout_f)
    ref = np.asarray(ppk.rowpad_conv(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(nbr), w_k,
        interpret=True, **kw), np.float32)
    w_port = rc.flip_weight(_t(w), cin_f, cout_f) if mode == "up" else _t(w)
    got = rc.rowpad_conv(_t(table).to(torch.bfloat16), _t(nbr), w_port,
                         **kw).numpy()
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["subm", "down"])
def test_rowpad_conv_dw_plain_vs_pallas_cin5(scene, mode):  # noqa: F811
    """K5's plain version at cin 5 against the Pallas weight-gradient
    kernel in interpret mode: the same bf16 products in f32, 1e-4 *
    max|ref|."""
    table, nbr, _, kw = _case(scene[2], mode, seed=8, cin=5, cout=16)
    zm_out = np.asarray(scene[2][1 if mode == "down" else 0]["rp_zmask"])
    d_out = _masked(np.random.RandomState(9), zm_out, kw["cout"])
    ref = np.asarray(ppk.dw_to_spconv(ppk.rowpad_conv_dw(
        jnp.asarray(table), jnp.asarray(nbr),
        jnp.asarray(d_out, jnp.bfloat16), interpret=True, **kw), 5, 16))
    got = rc.rowpad_conv_dw(_t(table), _t(nbr), _t(d_out), **kw).numpy()
    assert got.shape == ref.shape == (27, 5, 16)
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 16), (32, 32), (40, 48),
                                      (128, 128)])
def test_sliding_weight_layout(cin, cout):
    """K9's weight, (27, cout, cinp) bf16, against its plain form: each
    tap's (cin, cout) matrix transposed, rounded to bf16, zero from cin up
    to cinp, the multiple of 16 at or above cin."""
    w = np.random.RandomState(cin + cout).randn(27, cin, cout).astype(
        np.float32)
    got = rc.sliding_weight(torch.from_numpy(w), cin, cout)
    cinp = -(-cin // 16) * 16
    ref = np.zeros((27, cout, cinp), np.float32)
    ref[:, :, :cin] = w.transpose(0, 2, 1)
    ref = torch.from_numpy(ref).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (27, cout, cinp) and cinp % rc.SLIDING_CIN_ALIGN == 0
    assert torch.equal(got, ref)


def test_vfe_scatter_mean_yardstick(smoke):
    """K1's yardstick in chip_smoke.py (one scatter_reduce_ mean into a
    zeroed table) against K1's plain version on the tiny cloud's stream:
    within K1's tolerance, 2^-7 * max|ref| at a bf16 reference."""
    from detzero_tpu_torch.ops import stream_vfe

    pts, pv = smoke.entry_points(2048, seed=0)
    pts[..., :2] *= 6.0 / 70.0
    model = smoke.build_model(smoke.TINY_CFG, smoke.TINY_KW, torch.float32,
                              "cpu")
    s = model.build_table(torch.from_numpy(pts[0]),
                          torch.from_numpy(pv[0]))["stream"]
    args = (s["payload"], s["lane"], s["z"], s["wstart"])
    for dtype in (torch.float32, torch.bfloat16):
        kw = dict(nz=model.grid_zyx[0], ny=model.grid_zyx[1],
                  row_budget=model.row_budget, out_dtype=dtype)
        ref = stream_vfe.stream_rowpad_feats_plain(*args, **kw).float()
        got = smoke.vfe_scatter_mean(*args, **kw)()
        assert got.shape == ref.shape and int((ref != 0).sum()) > 1000
        tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-6) \
            * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol


def test_degenerate_pairs_plain(smoke):
    """The degenerate matched pairs that chip_smoke.py and the K6 `cuda`
    tests hold K6 to, on the plain clip: a zero-size A covers nothing, an
    identical pair overlaps by its own area, B of zero size leaves A's
    quad (the clip's on-edge rule), all finite."""
    from detzero_tpu_torch.ops import iou_bev

    a, b = smoke.degenerate_pairs("cpu")
    inter = iou_bev.boxes_overlap_bev_pairwise_plain(a, b)
    area = a[:, 2] * a[:, 3]
    assert a.shape == b.shape == (256, 5) and bool(torch.isfinite(inter).all())
    assert not bool(inter[:64].any())
    assert torch.allclose(inter[64:128], area[64:128], rtol=1e-4)
    assert torch.allclose(inter[96:128], area[96:128], rtol=1e-4)

"""What the redesigned K10 (rotated NMS: a suppression bitmask and a walk
over its 64-bit words) and K1 (stream VFE, a row's tile built in shared
memory) rely on, on the CPU against the JAX package:

  * the plain bitmask route, `nms_walk_bits_plain(nms_mask_plain(iou))`,
    equal to `nms._greedy_suppress` on the reference's own IoU matrix
    (`iou3d.boxes_iou_bev`) at k across the 64-box words, three
    thresholds, invalid entries, on the adversarial box families of
    tests/torch_iou_cases.py and on clustered boxes;
  * the TPU kernel itself (`pallas_iou.nms_keep_mask`, interpret mode)
    at k <= 128: the plain walk over the words of its own IoU tiles on
    every set, the port's whole plain keep mask where the reference's two
    IoU paths agree;
  * the mask's words zero in the lower triangle and past k;
  * K1's plain version against `pallas_pillar.stream_rowpad_feats`
    (interpret mode) and a float64 numpy reference on the edge scenes of
    tests/torch_vfe_cases.py.
The CUDA kernels are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.ops import iou3d, pallas_iou
from detzero_tpu.ops import nms as jnms
from detzero_tpu.ops import pallas_pillar as ppk
from detzero_tpu_torch.ops import nms, stream_vfe
from torch_iou_cases import FAMILIES, pair_set
from torch_vfe_cases import F, P_PAD, SCENES, vfe_scene

torch.set_num_threads(1)

SETS = FAMILIES + ["clustered"]
NMS_K = [1, 2, 63, 64, 65, 127, 300, 1024]
THRESH = (0.1, 0.5, 0.7)
POOL = 1024


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pool(name):
    """POOL score-sorted BEV boxes of one set, and their valid mask: a
    family's A and B boxes together, repeated at small shifts (so copies
    overlap each other) up to POOL, or 205 clusters of 5 jittered boxes as
    chip_smoke.clustered_boxes draws them; in a seeded random order."""
    rng = np.random.RandomState(SETS.index(name) + 3)
    if name == "clustered":
        base = rng.rand(POOL // 5 + 1, 1, 5) * [80.0, 80.0, 4.0, 2.0, 6.283] \
            + [-40.0, -40.0, 1.0, 1.0, -3.1416]
        jit = rng.randn(POOL // 5 + 1, 5, 5) * [0.3, 0.3, 0.2, 0.1, 0.2]
        boxes = (base + jit).reshape(-1, 5)[:POOL]
        boxes[:, 2:4] = np.abs(boxes[:, 2:4]) + 0.2
    else:
        base = np.concatenate(pair_set(name))
        reps = -(-POOL // len(base))
        boxes = np.concatenate([base + [0.37 * c, 0.11 * c, 0.0, 0.0, 0.0]
                                for c in range(reps)])[:POOL]
    boxes = boxes[rng.permutation(POOL)].astype(np.float32)
    return boxes, rng.rand(POOL) > 0.15


@functools.lru_cache(maxsize=None)
def _jax_iou(name):
    """The reference's IoU matrix of the set's pool: any k's matrix is its
    leading k x k block."""
    b = jnp.asarray(_pool(name)[0])
    return np.asarray(iou3d.boxes_iou_bev(b, b))


_greedy = jax.jit(jnms._greedy_suppress, static_argnums=2)


@pytest.mark.parametrize("k", NMS_K)
@pytest.mark.parametrize("name", SETS)
def test_walk_bits_plain_vs_greedy_suppress(name, k):
    iou = _jax_iou(name)[:k, :k]
    valid = _pool(name)[1][:k]
    for t in THRESH:
        ref = np.asarray(_greedy(jnp.asarray(iou), jnp.asarray(valid), t))
        words = nms.nms_mask_plain(_t(iou), t)
        got = nms.nms_walk_bits_plain(words, _t(valid)).numpy()
        assert np.array_equal(got, ref), (name, k, t)
        assert np.array_equal(nms.nms_walk_plain(_t(iou), _t(valid),
                                                 t).numpy(), ref)
    if k == POOL:
        assert 0 < ref.sum() < valid.sum()


@pytest.mark.parametrize("k", NMS_K)
def test_mask_words_upper_triangle_only(k):
    """Bit j % 64 of word (i, j / 64) is iou > t for j > i; the lower
    triangle, the diagonal and the columns past k are zero."""
    iou = _t(_jax_iou("clustered")[:k, :k])
    words = nms.nms_mask_plain(iou, 0.1)
    w = (k + 63) // 64
    assert words.shape == (k, w) and words.dtype == torch.int64
    bits = ((words[:, :, None] >> torch.arange(64)) & 1).reshape(k, -1)
    bits = bits.bool()
    assert not bits[:, k:].any()
    idx = torch.arange(k)
    upper = idx[None, :] > idx[:, None]
    assert torch.equal(bits[:, :k], (iou > 0.1) & upper)
    assert not bits[:, :k][~upper].any()
    if k > 64:
        assert bits[:, :k].any()


# the TPU kernel in interpret mode compiles once per padded size and
# threshold (~12 s at 128 boxes, ~40 s at 256, so one size): inputs are
# padded with invalid boxes, which neither keep nor suppress
PALLAS_PAD, PALLAS_T = 128, 0.5
PALLAS_K = (1, 2, 63, 64, 65, 127, 128)


@functools.lru_cache(maxsize=None)
def _pallas_iou(name):
    """The TPU IoU kernel's matrix of the set's first PALLAS_PAD boxes:
    its tiles run the clip of the NMS kernel's tiles, pair by pair."""
    b = jnp.asarray(_pool(name)[0][:PALLAS_PAD])
    return np.asarray(pallas_iou.boxes_iou_bev(b, b))


@pytest.mark.parametrize("name", SETS)
def test_keep_mask_plain_vs_pallas(name):
    """The TPU NMS kernel's keep mask equals the port's plain walk over the
    mask words of the TPU IoU kernel's matrix on every set, and the port's
    whole plain route (its own IoU, `nms_keep_mask_plain`) wherever the
    reference's own two IoU paths (Pallas and XLA) agree on every bit at
    the threshold: on the degenerate sets (sides of 1e-6, zero-size boxes)
    the 1e-6 union clamp turns last-bit differences of the clip into IoUs
    of thousands, and the two paths of the reference disagree there too."""
    boxes, valid = _pool(name)
    p_iou, x_iou = _pallas_iou(name), _jax_iou(name)
    whole, pad, t = 0, PALLAS_PAD, PALLAS_T
    b = jnp.asarray(boxes[:pad])
    for k in PALLAS_K:
        v = jnp.asarray(np.arange(pad) < k) & jnp.asarray(valid[:pad])
        ref = np.asarray(pallas_iou.nms_keep_mask(b, v, t, budget=128))
        assert not ref[k:].any()
        ref, vk = ref[:k], _t(valid[:k])
        words = nms.nms_mask_plain(_t(p_iou[:k, :k]), t)
        got = nms.nms_walk_bits_plain(words, vk).numpy()
        assert np.array_equal(got, ref), (name, k, t)
        upper = np.triu(np.ones((k, k), bool), 1)
        if np.array_equal((p_iou[:k, :k] > t) & upper,
                          (x_iou[:k, :k] > t) & upper):
            got = nms.nms_keep_mask_plain(_t(boxes[:k]), vk, t).numpy()
            assert np.array_equal(got, ref), (name, k, t)
            whole += 1
    if name in ("random", "clustered", "far_degenerate"):
        assert whole == len(PALLAS_K)


@pytest.mark.parametrize("name", SETS)
def test_keep_mask_cpu_routes_agree(name):
    """On CPU tensors `nms_keep_mask` takes the plain float walk; the
    bitmask route over `nms_mask` gives the same keep mask."""
    boxes, valid = (_t(x[:300]) for x in _pool(name))
    keep = nms.nms_keep_mask(boxes, valid, 0.7)
    assert torch.equal(keep, nms.nms_walk_bits(nms.nms_mask(boxes, 0.7),
                                               valid))
    assert torch.equal(keep, nms.nms_keep_mask_plain(boxes, valid, 0.7))


@pytest.mark.parametrize("fn", ["nms_keep_mask", "nms_mask",
                                "nms_walk_bits"])
def test_nms_wrappers_raise_off_cpu_and_cuda(fn):
    """A 'meta' tensor is neither on the CPU nor on a card: the wrappers
    refuse it, they do not fall back to the plain versions."""
    meta = dict(device="meta")
    boxes = torch.empty(70, 5, **meta)
    valid = torch.empty(70, dtype=torch.bool, **meta)
    words = torch.empty(70, 2, dtype=torch.int64, **meta)
    call = {"nms_keep_mask": lambda: nms.nms_keep_mask(boxes, valid, 0.5),
            "nms_mask": lambda: nms.nms_mask(boxes, 0.5),
            "nms_walk_bits": lambda: nms.nms_walk_bits(words, valid)}[fn]
    with pytest.raises(ValueError, match="CUDA"):
        call()


# ---------------------------------------------------------------- K1

def _vfe_numpy(d):
    """Per-slot float64 sums / max(weight, 1) of the points inside the
    windows whose lane and z select a slot."""
    ny, nz, b = d["ny"], d["nz"], d["b"]
    out = np.zeros((ny, b, nz, F + 1))
    for y in range(ny):
        for i in range(d["wstart"][y], d["wstart"][y + 1]):
            lane, z = d["lane"][i], d["z"][i]
            if 0 <= lane < b and 0 <= z < nz:
                out[y, lane, z] += d["payload"][i]
    feats = out[..., :F] / np.maximum(out[..., F:], 1.0)
    return feats.transpose(0, 2, 3, 1).reshape(ny, nz * F, b)


@pytest.mark.parametrize("scene", SCENES)
def test_stream_vfe_plain_vs_pallas_edges(scene):
    d = vfe_scene(scene)
    nq = P_PAD // 128
    tiles = d["payload"].reshape(nq, 128, F + 1).transpose(0, 2, 1)
    meta = np.stack([d["lane"], d["z"]], 1).reshape(nq, 128, 2)
    kw = dict(nz=d["nz"], ny=d["ny"], row_budget=d["b"])
    ref = np.asarray(ppk.stream_rowpad_feats(
        jnp.asarray(tiles.reshape(nq * (F + 1), 128)),
        jnp.asarray(meta.transpose(0, 2, 1).reshape(nq * 2, 128)),
        jnp.asarray(d["wstart"]), interpret=True, **kw))
    got = stream_vfe.stream_rowpad_feats(
        *(_t(d[k]) for k in ("payload", "lane", "z", "wstart")),
        **kw).numpy()
    exact = _vfe_numpy(d)
    scale = np.abs(exact).max()
    assert got.shape == ref.shape == (d["ny"], d["nz"] * F, d["b"])
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.abs(got - exact).max() <= 1e-5 * scale
    empty = np.diff(d["wstart"]) == 0
    assert not got[empty].any()
    if scene == "empty_rows":
        assert empty.sum() >= 4 and got[~empty].any()

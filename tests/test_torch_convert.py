"""Reference flax weights -> detzero_tpu_torch state_dict: every leaf
consumed, every parameter filled, and the BEV backbone and center head match
the reference module by module (this pins flax's stride-2 'SAME' padding and
the unflipped ConvTranspose kernel)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as nn

from detzero_tpu.core.config import Config
from detzero_tpu.models.detection.backbone2d import BaseBEVBackbone
from detzero_tpu.models.detection.center_head import CenterHead
from detzero_tpu.models.detection.centerpoint import CenterPoint as JaxCP
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.models.layers import Conv2dSame

torch.set_num_threads(1)

CFG = {"WITH_VELOCITY": True, "WITH_IOU": True,
       "CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
       "VOXEL_CAPACITIES": (512, 256, 128, 64),
       "BACKBONE3D": "pillar_pallas", "BEV_LAYER_NUMS": (2, 2)}
KW = dict(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 2.0),
          voxel_size=(0.2, 0.2, 0.5), max_voxels=512, max_points=2048,
          max_objs=8)


def randomize_stats(variables, seed):
    """Non-trivial BN statistics and affines (init leaves them identity)."""
    rng = np.random.RandomState(seed)

    def one(path, a):
        name = path[-1].key
        a = np.array(a)
        if name == "mean":
            return (rng.randn(*a.shape) * 0.2).astype(np.float32)
        if name in ("var", "scale"):
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if name == "bias" and len(path) > 2 \
                and path[-2].key.startswith("MaskedBatchNorm"):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(one, variables)


@pytest.fixture(scope="module")
def converted():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-6, 6, (1, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (1, 2048))
    jm = JaxCP(Config(CFG), 3, dtype=jnp.float32, **KW)
    v = jm.init(jax.random.PRNGKey(0), pts, np.ones((1, 2048), bool))
    v = randomize_stats(jax.tree.map(np.asarray, v), 1)
    model = CenterPoint(CFG, 3, dtype=torch.float32, **KW)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    return v, model


def _sub(v, name):
    return {"params": v["params"][name], "batch_stats": v["batch_stats"][name]}


def test_every_leaf_converted(converted):
    v, model = converted
    n_leaves = len(jax.tree.leaves(v))
    assert n_leaves == len(model.state_dict())
    sd = convert_centerpoint(v, model)
    # HWIO -> OIHW, and the transposed conv flipped in space
    k = v["params"]["backbone2d"]["ConvBNReLU_0"]["Conv_0"]["kernel"]
    assert np.array_equal(sd["backbone2d.ConvBNReLU_0.Conv_0.weight"].numpy(),
                          k.transpose(3, 2, 0, 1))
    kt = v["params"]["backbone2d"]["ConvTranspose_0"]["kernel"]
    assert np.array_equal(sd["backbone2d.ConvTranspose_0.weight"].numpy(),
                          kt[::-1, ::-1].transpose(2, 3, 0, 1))


def test_round_trip_and_params_only(converted):
    """to_flax undoes the conversion leaf by leaf; a params-only tree (the
    shape of the reference's gradients) converts to the parameter names."""
    v, model = converted
    back = to_flax(convert_centerpoint(v, model))
    ref = jax.tree_util.tree_flatten_with_path(v)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert np.array_equal(np.asarray(a), b), path
    params = convert_centerpoint({"params": v["params"]}, model)
    assert set(params) == {n for n, _ in model.named_parameters()}
    ref = jax.tree_util.tree_flatten_with_path({"params": v["params"]})[0]
    got = jax.tree_util.tree_flatten_with_path(to_flax(params))[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert np.array_equal(np.asarray(a), b), path


def test_converter_raises_on_mismatch(converted):
    v, model = converted
    extra = {"params": dict(v["params"], stray={"w": np.zeros(3)}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="no conversion rule"):
        convert_centerpoint(extra, model)
    missing = {"params": {k: x for k, x in v["params"].items()
                          if k != "center_head"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="unfilled"):
        convert_centerpoint(missing, model)


@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_bev_backbone_parity(converted, hw):
    v, model = converted
    x = np.random.RandomState(2).randn(*hw, 128).astype(np.float32)
    ref = BaseBEVBackbone(layer_nums=(2, 2), use_running_average=True).apply(
        _sub(v, "backbone2d"), jnp.asarray(x))
    got = model.backbone2d(torch.from_numpy(x))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got.detach().numpy() - ref).max() \
        <= 1e-4 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("size,stride", [(8, 2), (7, 2), (9, 1)])
def test_same_padding_conv(size, stride):
    """flax 'SAME' at stride 2 pads (0, 1) on even and (1, 1) on odd sizes;
    torch's padding=1 would shift the even case by one cell."""
    rng = np.random.RandomState(size)
    x = rng.randn(1, size, size + 2, 6).astype(np.float32)
    conv = nn.Conv(5, (3, 3), strides=(stride, stride), padding="SAME",
                   use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(params, jnp.asarray(x)))
    mod = Conv2dSame(6, 5, 3, stride)
    mod.weight.data = torch.from_numpy(
        np.array(params["params"]["kernel"]).transpose(3, 2, 0, 1))
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    assert np.abs(got.detach().numpy() - ref).max() <= 1e-5


def test_center_head_parity(converted):
    v, model = converted
    x = np.random.RandomState(3).randn(8, 8, 512).astype(np.float32)
    ref = CenterHead(class_ids_each_head=((0,), (1, 2)),
                     use_running_average=True).apply(
        _sub(v, "center_head"), jnp.asarray(x))
    got = model.center_head(torch.from_numpy(x))
    for r, g in zip(ref, got):
        assert list(r) == list(g)
        for k in r:
            a = np.asarray(r[k])
            assert np.abs(g[k].detach().numpy() - a).max() \
                <= 1e-4 * max(np.abs(a).max(), 1.0), k

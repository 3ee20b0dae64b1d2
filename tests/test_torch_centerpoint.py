"""The slice as a whole: detzero_tpu_torch CenterPoint inference against the
reference CenterPoint.predict on the CPU, tiny geometry, converted weights.

(a) raw head outputs within 1e-3 * max(|ref|, 1);
(b) the port's decode + NMS on the reference's head outputs: keep masks
    exactly equal, boxes within 1e-5, scores and labels equal where kept;
(c) predict end to end: as many boxes kept, the same labels, boxes within
    1e-3 where kept;
(d) configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml, whose
    BACKBONE3D 'pillar' has no row budget in the reference: with no
    PILLAR_ROW_BUDGET set, the port keeps every pillar of a row of more
    than 128, and its heads equal the reference's 'pillar' route's within
    (a)'s bound.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.core.config import Config
from detzero_tpu.core.config import cfg_from_yaml_file as ref_cfg_from_yaml
from detzero_tpu.models.detection.center_head import (
    decode_predictions as jax_decode,
)
from detzero_tpu.models.detection.centerpoint import CenterPoint as JaxCP
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.core.config import Config as PortConfig
from detzero_tpu_torch.core.config import cfg_from_yaml_file
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.tools import common
from tools import common as ref_common

from test_torch_convert import CFG, KW, randomize_stats

torch.set_num_threads(1)

# score_thresh 0 and a low NMS threshold so the walk suppresses real boxes
DECODE = dict(score_thresh=0.0, nms_thresh=0.3)


@pytest.fixture(scope="module")
def both():
    rng = np.random.RandomState(5)
    pts = rng.uniform(-6, 6, (1, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (1, 2048))
    pv = rng.rand(1, 2048) > 0.05
    jm = JaxCP(Config(CFG), 3, dtype=jnp.float32, **KW)
    v = jm.init(jax.random.PRNGKey(0), pts, pv)
    v = randomize_stats(jax.tree.map(np.asarray, v), 7)
    preds, _, _ = jax.jit(lambda v_, p, q: jm.apply(
        v_, p, q, train=False, mutable_stats=False))(v, pts, pv)
    dec = jax.jit(jax.vmap(lambda pr: jax_decode(
        pr, jm.class_ids_each_head, jm.bev_hw, jm.feature_map_stride,
        jm.voxel_size, jm.pc_range, **DECODE)))
    ref_out = dec(preds)         # == jm.predict(v, pts, pv, **DECODE)
    model = CenterPoint(CFG, 3, dtype=torch.float32, device="cpu", **KW)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    return pts, pv, jax.tree.map(np.asarray, preds), \
        jax.tree.map(np.asarray, ref_out), model


def test_raw_head_outputs(both):
    pts, pv, preds, _, model = both
    got = model.forward_one(torch.from_numpy(pts[0]), torch.from_numpy(pv[0]))
    assert len(got) == len(preds) == 2
    for ref_h, got_h in zip(preds, got):
        assert set(ref_h) == set(got_h) == {
            "hm", "center", "center_z", "dim", "rot", "vel", "iou"}
        for k in ref_h:
            a = ref_h[k][0]
            b = got_h[k].numpy()
            assert a.shape == b.shape, k
            assert np.abs(a - b).max() <= 1e-3 * max(np.abs(a).max(), 1.0), k


def test_decode_and_nms_on_reference_heads(both):
    _, _, preds, ref, model = both
    heads = [{k: torch.from_numpy(np.array(x[0])) for k, x in h.items()}
             for h in preds]
    got = model.decode(heads, **DECODE)
    m = ref["mask"][0]
    assert 0 < m.sum() < 256
    assert np.array_equal(got["mask"].numpy(), m)
    assert np.abs(got["boxes"].numpy()[m] - ref["boxes"][0][m]).max() <= 1e-5
    assert np.abs(got["scores"].numpy()[m] - ref["scores"][0][m]).max() \
        <= 1e-6
    assert np.array_equal(got["labels"].numpy()[m], ref["labels"][0][m])


def test_predict_end_to_end(both):
    pts, pv, _, ref, model = both
    got = model.predict(torch.from_numpy(pts), torch.from_numpy(pv), **DECODE)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "boxes": (1, 256, 9), "scores": (1, 256), "labels": (1, 256),
        "mask": (1, 256)}
    m = ref["mask"][0]
    assert int(got["mask"].sum()) == int(m.sum())
    gm = got["mask"].numpy()[0]
    assert np.array_equal(got["labels"].numpy()[0][gm], ref["labels"][0][m])
    assert np.abs(got["boxes"].numpy()[0][gm] - ref["boxes"][0][m]).max() \
        <= 1e-3


SYNTHETIC_CPU = "configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml"


def test_pillar_route_keeps_every_pillar_of_a_row():
    # one BEV layer a level, for time; the row budget is left unset
    cfgs = [load(SYNTHETIC_CPU, cls()) for load, cls in (
        (cfg_from_yaml_file, PortConfig), (ref_cfg_from_yaml, Config))]
    for cfg in cfgs:
        cfg["MODEL"]["BEV_LAYER_NUMS"] = [1, 1]
        assert "PILLAR_ROW_BUDGET" not in cfg["MODEL"]
        assert "BACKBONE3D" not in cfg["MODEL"]
    model = common.build_detector(cfgs[0], "cpu", dtype=torch.float32,
                                  seed=2)
    nz, ny, nx = model.grid_zyx
    assert model.row_budget == nx == 192
    # the synthetic cloud's 4096 points: 1024 along the BEV row at y = 0.1
    # (every one of its 192 columns), the rest uniform in the range
    rng = np.random.RandomState(11)
    n, f = 4096, 6
    pts = np.zeros((1, n, f), np.float32)
    pts[0, :, 0] = rng.uniform(-19.1, 19.1, n)
    pts[0, :, 1] = rng.uniform(-19.1, 19.1, n)
    pts[0, :1024, 0] = np.linspace(-19.15, 19.15, 1024)
    pts[0, :1024, 1] = 0.1
    pts[0, :, 2] = rng.uniform(-1.5, 1.5, n)
    pts[0, :, 3:5] = rng.rand(n, 2)
    pv = np.ones((1, n), bool)
    plan = model.build_plan(model.build_table(torch.from_numpy(pts[0]),
                                              torch.from_numpy(pv[0])))
    cells = plan[0]["cells"][plan[0]["mask"]].numpy()
    assert np.bincount(cells // nx).max() > 128

    v = randomize_stats(to_flax(model.state_dict()), 3)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    jm = ref_common.build_detector(cfgs[1], dtype=jnp.float32)
    assert jm.backend == "pillar"
    preds, _, _ = jax.jit(lambda v_, p, q: jm.apply(
        v_, p, q, train=False, mutable_stats=False))(v, pts, pv)
    got = model.forward_one(torch.from_numpy(pts[0]), torch.from_numpy(pv[0]))
    for ref_h, got_h in zip(preds, got):
        for k in ref_h:
            a = np.asarray(ref_h[k])[0]
            b = got_h[k].numpy()
            assert a.shape == b.shape, k
            assert np.abs(a - b).max() <= 1e-3 * max(np.abs(a).max(), 1.0), k

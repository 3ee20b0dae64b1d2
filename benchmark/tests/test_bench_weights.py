"""The seeded weights: every one-stage draw is the one the harness made
before the fan-in rule learnt the two-stage leaves, the rule gives every
two-stage leaf the fan-in the program's own `init_parameters` uses, and
`Run.setup`'s calibration hook replaces the calibration."""

import json
import math
from pathlib import Path

import pytest
import torch
from torch import nn

from benchmark import harness, resolve, weights

HERE = Path(__file__).resolve().parent
TINY = HERE / "tiny"
SEED = 3_000_000_029
# the second stage: configs/det_model_cfgs/centerpoint_pdv_5sweeps.yaml on
# the flagship, and the tiny two-stage check's RoI sizes on the tiny one
TWO_STAGE = {
    "flagship": dict(SECOND_STAGE=True, ROI_BUDGET=128, ROI_GRID_SIZE=6,
                     ROI_ATTENTION=True),
    "tiny": dict(SECOND_STAGE=True, ROI_BUDGET=16, ROI_GRID_SIZE=3,
                 ROI_ATTENTION=True),
}


def parent_fan_in(name, shape):
    """The fan-in rule as it stood before it knew the two-stage leaves."""
    if name.endswith(".kernel"):
        return shape[0] * shape[1]
    if len(shape) == 4:
        if "ConvTranspose" in name:
            return shape[0] * shape[2] * shape[3]
        return shape[1] * shape[2] * shape[3]
    raise ValueError(f"no fan-in rule for {name} {tuple(shape)}")


def parent_make(shapes, seed, device):
    """`weights.make` as it stood before the two-stage rules."""
    drawn = [k for k, s in shapes.items()
             if k.endswith((".kernel", ".weight"))]
    total = sum(math.prod(shapes[k]) for k in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 7) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, shape in shapes.items():
        if k in drawn:
            n = math.prod(shape)
            out[k] = flat[off:off + n].reshape(shape) / math.sqrt(
                parent_fan_in(k, shape))
            off += n
        elif k.endswith((".scale", ".var")):
            out[k] = torch.ones(shape, device=device)
        elif k.endswith("hm_out.bias"):
            out[k] = torch.full(shape, weights.HM_BIAS, device=device)
        elif k.endswith((".bias", ".mean")):
            out[k] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"no rule for {k}")
    return out


def _config(which, two_stage=False):
    if which == "flagship":
        config = resolve.cell("cp5.predict.lidar5")["config_data"]
    else:
        config = json.loads((TINY / "configs" / "tiny.json").read_text())
    if two_stage:
        config["MODEL"].update(TWO_STAGE[which])
    return config


def _model(which, two_stage=False):
    return harness.build_model(_config(which, two_stage), "meta")


@pytest.mark.parametrize("which", ["flagship", "tiny"])
def test_one_stage_fan_in_unchanged(which):
    shapes = harness.state_shapes(_model(which))
    drawn = [k for k in shapes if k.endswith((".kernel", ".weight"))]
    assert drawn
    for k in drawn:
        assert weights.fan_in(k, shapes[k]) == parent_fan_in(k, shapes[k]), k


def test_make_is_bit_identical_on_tiny():
    shapes = harness.state_shapes(_model("tiny"))
    got = weights.make(shapes, SEED, "cpu")
    want = parent_make(shapes, SEED, "cpu")
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_setup_hooks():
    """The defaults give the parent's draw, calibrated as before; a
    `calibrate` hook replaces the calibration."""
    cell = resolve.cell("tiny.predict", base=TINY)
    run = harness.Run(cell, SEED, 0, False, "cpu", 0.0)
    run.setup()
    pool = run.pool
    want = weights.calibrate(parent_make(run.shapes, SEED, "cpu"),
                             pool["points"][:1], pool["points_valid"][:1],
                             run.rcfg)
    assert list(run.weights) == list(want)
    for k in want:
        assert torch.equal(run.weights[k], want[k]), k
    run = harness.Run(cell, SEED, 0, False, "cpu", 0.0)
    run.setup(calibrate=lambda sd, points, valid, rcfg: sd)
    var = [k for k in run.weights if k.endswith(".var")]
    assert var and all(bool((run.weights[k] == 1).all()) for k in var)


def _init_fan_in(model):
    """{leaf: fan-in} as `CenterPoint.init_parameters` draws each kernel."""
    from detzero_tpu_torch.models.detection.centerpoint import (
        SparseConvBNReLU)
    from detzero_tpu_torch.models.layers import DenseGeneral

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            out[f"{name}.weight"] = mod.in_features
        elif isinstance(mod, DenseGeneral):
            out[f"{name}.kernel"] = math.prod(mod.in_shape)
        elif isinstance(mod, SparseConvBNReLU):
            kv, cin, _ = mod.kernel.shape
            out[f"{name}.kernel"] = kv * cin
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            cin = w.shape[0 if isinstance(mod, nn.ConvTranspose2d) else 1]
            out[f"{name}.weight"] = cin * w.shape[2] * w.shape[3]
    return out


@pytest.mark.parametrize("which", ["flagship", "tiny"])
def test_two_stage_fan_in_matches_init(which):
    model = _model(which, two_stage=True)
    shapes = harness.state_shapes(model)
    want = _init_fan_in(model)
    drawn = [k for k in shapes if k.endswith((".kernel", ".weight"))]
    assert sorted(want) == sorted(drawn)
    assert any(k.startswith("roi_head.") for k in drawn)
    for k in drawn:
        assert weights.fan_in(k, shapes[k]) == want[k], k
    # the attention's input projections, which the sparse-kernel rule
    # would give heads times the input width
    assert {k for k in drawn if k.endswith(".query.kernel")} == {
        "roi_head.grid_attn.query.kernel"}

"""detzero_tpu_torch.core.optim against detzero_tpu.core.optim: the same
gradient trees fed for 50 steps into both packages' build_optimizer with the
flagship's OPTIMIZATION block (configs/det_model_cfgs/centerpoint_5sweeps
.yaml) at a short total_steps, on the tiny model's parameter tree; the
gradient norm alternates above and below GRAD_NORM_CLIP."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from detzero_tpu.core import optim as jax_optim
from detzero_tpu.core.config import Config
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.core import optim
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

from test_torch_convert import CFG, KW

torch.set_num_threads(1)

FLAGSHIP_OPT = {"OPTIMIZER": "adam_onecycle", "LR": 0.003,
                "WEIGHT_DECAY": 0.01, "GRAD_NORM_CLIP": 10.0,
                "PCT_START": 0.4, "DIV_FACTOR": 10}
STEPS = 50


@pytest.fixture(scope="module")
def model():
    """Every parameter random (init leaves biases at zero, which would make
    max|p| of a one-element leaf meaningless as a scale)."""
    m = CenterPoint(CFG, 3, dtype=torch.float32, **KW)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return m


def _grads(params, step):
    """Random gradient tree; odd steps are 1e-4 smaller, so the global norm
    (~1e3 at scale 1) falls below the clip threshold of 10 there."""
    rng = np.random.RandomState(100 + step)
    scale = 1e-4 if step % 2 else 1.0
    return jax.tree.map(
        lambda p: (rng.randn(*p.shape) * scale).astype(np.float32), params)


def test_wd_mask_matches(model):
    params = to_flax(dict(model.named_parameters()))["params"]
    ref = {"/".join(str(k.key) for k in path): bool(v) for path, v in
           jax.tree_util.tree_flatten_with_path(
               jax_optim.wd_mask(params))[0]}
    got = optim.wd_mask(n for n, _ in model.named_parameters())
    got = {n.replace(".", "/").replace("/weight", "/kernel"): v
           for n, v in got.items()}
    assert got == ref
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("name,steps", [("adam_onecycle", STEPS),
                                        ("adamW", 20), ("sgd", 20)])
def test_optimizer_matches_optax(model, name, steps):
    """The flagship block for 50 steps; the other branches (b2 0.999, and
    SGD with momentum and a piecewise-constant schedule) for 20."""
    cfg = dict(FLAGSHIP_OPT, OPTIMIZER=name)
    params0 = to_flax(dict(model.named_parameters()))["params"]
    tx, schedule = jax_optim.build_optimizer(Config(cfg), steps)
    update = jax.jit(tx.update)
    params = jax.tree.map(jnp.asarray, params0)
    state = tx.init(params)

    m = CenterPoint(CFG, 3, dtype=torch.float32, **KW)
    m.load_state_dict(model.state_dict())
    opt = optim.build_optimizer(cfg, steps, m)
    named = dict(m.named_parameters())
    clipped = unclipped = 0
    for step in range(steps):
        g = _grads(params0, step)
        # the optimizer state counts in int32, as the schedule sees it
        lr_ref = float(schedule(jnp.int32(step)))
        assert abs(opt.lr - lr_ref) <= 1e-7 * abs(lr_ref), step
        ref_norm = float(optax.global_norm(g))
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        for k, v in convert_centerpoint({"params": g}, m).items():
            named[k].grad = v
        norm = float(opt.step())
        assert abs(norm - ref_norm) <= 1e-5 * ref_norm
        clipped += ref_norm >= 10.0
        unclipped += ref_norm < 10.0
    assert clipped and unclipped
    got = to_flax(named)["params"]
    # per leaf, 1e-5 * max|p| with p the leaf before or after the 50 steps:
    # a one-element leaf that the updates carry close to zero has no scale
    # of its own
    for (path, ref), val, p0 in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree.leaves(got), jax.tree.leaves(params0)):
        ref = np.asarray(ref)
        scale = max(np.abs(ref).max(), np.abs(p0).max())
        assert np.abs(val - ref).max() <= 1e-5 * scale, path


def test_schedules_match_optax():
    for name, steps in (("adam_onecycle", 50), ("adam_onecycle", 1000),
                        ("sgd", 100)):
        cfg = dict(FLAGSHIP_OPT, OPTIMIZER=name)
        ref = jax_optim.build_schedule(Config(cfg), steps)
        got = optim.build_schedule(cfg, steps)
        for step in range(steps + 3):
            r = float(ref(jnp.int32(step)))
            assert abs(got(step) - r) <= 1e-7 * abs(r), (name, steps, step)


def test_paramwise_raises(model):
    with pytest.raises(NotImplementedError, match="PARAMWISE"):
        optim.build_optimizer(dict(FLAGSHIP_OPT, PARAMWISE={"custom_keys": {
            "center_head": {"lr_mult": 0.1}}}), STEPS, model)

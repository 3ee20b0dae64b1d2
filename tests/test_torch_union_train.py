"""One training step of CenterPoint under `DOWNSAMPLE_SITE_MODE: union`
against the reference on the CPU, float32, batch 2 at the tiny geometry
(tests/test_torch_train_step.py's batch, weights, BN statistics and
capacities, which hold every union site; one BEV layer a level):

  * the loss and every aux term of the port's Trainer step within 1e-4
    relative of the reference's `CenterPoint.loss`;
  * the 3D backbone's train-mode output (the BEV map) within 1e-4 *
    max|ref|;
  * every 3D-backbone gradient leaf (the stem, the blocks, the three down
    convs over the union sites and their transposes, the masked BN over
    the union zmasks) within 2e-2 * max|ref leaf|, as jax.vjp and
    torch.autograd give it for one seeded cotangent of the BEV map;
  * every 2D-backbone and head gradient leaf within 1e-3 * max|ref leaf|,
    both packages on the port's BEV map and the step's targets, in
    float64.

The bounds are tests/test_torch_train_step.py's.  The whole step's 2D and
head leaves are not compared in float32: at this geometry's random init
that gradient jumps between branches (a 1e-6 relative change of the
reference's weights moves its 2D-backbone leaves 21-260 times the 1e-3
bound, the same under 'principal'), and the packages' float32 BEV maps,
8e-6 relative apart, sit on different branches; the port's float32 step
equals its float64 step within the bound there.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as nn

from detzero_tpu.core.config import Config
from detzero_tpu.models.detection.backbone2d import BaseBEVBackbone as JaxBEV
from detzero_tpu.models.detection.center_head import CenterHead as JaxHead
from detzero_tpu.models.detection.center_head import (
    assign_targets as jax_targets,
)
from detzero_tpu.models.detection.center_head import (
    center_head_loss as jax_head_loss,
)
from detzero_tpu.models.detection.centerpoint import CenterPoint as JaxCP
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.core.optim import build_optimizer
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.parallel.trainer import Trainer

from test_torch_convert import KW, randomize_stats
from test_torch_optim import FLAGSHIP_OPT
from test_torch_train_step import TRAIN_CFG, _torch_batch, make_batch

torch.set_num_threads(1)

CFG = dict(TRAIN_CFG, DOWNSAMPLE_SITE_MODE="union", BEV_LAYER_NUMS=(1, 1))
HEAD_PARTS = ("backbone2d", "center_head")


class BevHead(nn.Module):
    """The reference's 2D backbone and head as CenterPointNet builds them,
    on a given BEV map."""

    jm: JaxCP
    dtype: object

    @nn.compact
    def __call__(self, bev):
        kw = dict(use_running_average=False, axis_names=("batch",),
                  dtype=self.dtype)
        net = self.jm.net
        x = JaxBEV(layer_nums=net.bev_layer_nums,
                   num_filters=net.bev_num_filters, name="backbone2d",
                   **kw)(bev)
        return JaxHead(class_ids_each_head=self.jm.class_ids_each_head,
                       with_velocity=net.with_velocity, with_iou=net.with_iou,
                       name="center_head", **kw)(x)


@pytest.fixture(scope="module")
def step():
    batch = make_batch()
    model = CenterPoint(CFG, 3, dtype=torch.float32, device="cpu", **KW)
    model.init_parameters(torch.Generator().manual_seed(0))
    v = randomize_stats(to_flax(model.state_dict()), 4)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    jm = JaxCP(Config(CFG), 3, dtype=jnp.float32, **KW)
    assert jm.site_mode == "union"
    args = (batch["points"], batch["points_valid"], batch["gt_boxes"],
            batch["gt_classes"], batch["gt_valid"])
    tb = _torch_batch(batch)

    # the port's train-mode BEV map and its 3D-backbone VJP of a seeded
    # cotangent, the BN statistics restored after
    stats = {k: b.clone() for k, b in model.named_buffers()}
    model.train()
    bb = model.backbone3d
    bev = bb(*model.prepare(tb["points"], tb["points_valid"]))[
        "spatial_features"]
    ct = torch.from_numpy(np.random.RandomState(9).randn(*bev.shape).astype(
        np.float32))
    names = [k for k, _ in bb.named_parameters()]
    g3 = torch.autograd.grad(bev, list(bb.parameters()), ct)
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(stats[k])
    got = {"bev": bev.detach(), "g3": {f"backbone3d.{k}": g
                                       for k, g in zip(names, g3)}}

    kw = dict(hw=jm.bev_hw, feature_map_stride=jm.feature_map_stride,
              voxel_size=jm.voxel_size, pc_range=jm.pc_range)
    tgt = jax.vmap(functools.partial(
        jax_targets, class_ids_each_head=jm.class_ids_each_head,
        max_objs=jm.max_objs, with_velocity=True, **kw))(*args[2:])

    def ref_fn(params):
        """CenterPoint.loss's one-stage terms on one train-mode forward,
        and the VJP of its BEV map."""
        def forward(p):
            preds, out3d, _ = jm.apply(
                {"params": p, "batch_stats": v["batch_stats"]}, *args[:2],
                train=True)
            return out3d["spatial_features"], preds

        sf, vjp, preds = jax.vjp(forward, params, has_aux=True)
        per, aux = jax.vmap(functools.partial(jax_head_loss, **kw))(preds,
                                                                    tgt)
        return per.mean(), aux, sf, vjp(jnp.asarray(ct.numpy()))[0]

    loss, aux, sf, g3_ref = jax.jit(ref_fn)(v["params"])
    ref = {"loss": float(loss), "aux": jax.tree.map(np.asarray, aux),
           "bev": np.asarray(sf), "g3": convert_centerpoint(
               {"params": jax.tree.map(np.asarray, g3_ref)}, model)}

    # the whole step on the port
    trainer = Trainer(model, build_optimizer(FLAGSHIP_OPT, 10, model))
    got["loss"], got["aux"], _ = trainer.step(tb)
    return jm, v, batch, model, ref, got


def test_union_step_loss_and_aux(step):
    *_, ref, got = step
    assert abs(float(got["loss"]) - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    assert set(got["aux"]) == set(ref["aux"])
    for k, r in ref["aux"].items():
        assert np.abs(got["aux"][k].numpy() - r).max() \
            <= 1e-4 * np.abs(r).max(), k


def test_union_step_bev_map(step):
    *_, ref, got = step
    a, b = ref["bev"], got["bev"].numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
    assert (a != 0).mean() > 0.3


def test_union_step_backbone3d_gradients(step):
    *_, model, ref, got = step
    want = {k: w for k, w in ref["g3"].items() if k.startswith("backbone3d.")}
    assert set(want) == set(got["g3"]) and len(want) > 60
    for k, r in want.items():
        r = r.numpy()
        g = got["g3"][k].numpy()
        assert np.abs(g - r).max() <= 2e-2 * np.abs(r).max(), k
    assert float(np.abs(got["g3"]["backbone3d.SparseConvBNReLU_0.kernel"]
                        .numpy()).max()) > 0


def test_union_step_bev_and_head_gradients(step):
    """Both packages' 2D backbone and head on the port's BEV map of the
    step, float64: the loss and every leaf's gradient."""
    jm, v, batch, model, _, got = step
    m64 = CenterPoint(CFG, 3, dtype=torch.float64, device="cpu", **KW)
    m64.load_state_dict(convert_centerpoint(v, m64), strict=True)
    m64 = m64.double().train()
    tb = {k: torch.from_numpy(batch[k]) for k in ("gt_classes", "gt_valid")}
    tb["gt_boxes"] = torch.from_numpy(batch["gt_boxes"]).double()
    bev = got["bev"].double()
    loss, _ = m64.head_loss(m64.bev_head(bev), m64.targets(
        tb["gt_boxes"], tb["gt_classes"], tb["gt_valid"]))
    loss.mean().backward()
    grads = {k: p.grad for k, p in m64.named_parameters()
             if k.split(".")[0] in HEAD_PARTS}

    stack = BevHead(jm, jnp.float64)
    vmapped = nn.vmap(BevHead.__call__, variable_axes={
        "params": None, "batch_stats": None}, split_rngs={"params": False},
        in_axes=0, out_axes=0, axis_name="batch")
    kw = dict(hw=jm.bev_hw, feature_map_stride=jm.feature_map_stride,
              voxel_size=jm.voxel_size, pc_range=jm.pc_range)
    tgt_fn = functools.partial(jax_targets,
                               class_ids_each_head=jm.class_ids_each_head,
                               max_objs=jm.max_objs, with_velocity=True, **kw)

    def ref_loss(params, stats, bev_in, gb, gc, gv):
        preds, _ = stack.apply({"params": params, "batch_stats": stats},
                               bev_in, method=vmapped,
                               mutable=["batch_stats"])
        tgt = jax.vmap(tgt_fn)(gb, gc, gv)
        per, _ = jax.vmap(functools.partial(jax_head_loss, **kw))(preds, tgt)
        return per.mean()

    def f64(tree):
        return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)

    with jax.enable_x64(True):
        ref_l, ref_g = jax.jit(jax.value_and_grad(ref_loss))(
            f64({k: v["params"][k] for k in HEAD_PARTS}),
            f64({k: v["batch_stats"][k] for k in HEAD_PARTS}),
            bev.numpy(), batch["gt_boxes"].astype(np.float64),
            batch["gt_classes"], batch["gt_valid"])
        ref_l = float(ref_l)
    assert abs(float(loss.mean()) - ref_l) <= 1e-6 * abs(ref_l)
    full = {k: jax.tree.map(np.zeros_like, t) for k, t in v["params"].items()}
    full.update(jax.tree.map(np.asarray, ref_g))
    want = {k: w for k, w in convert_centerpoint(
        {"params": full}, model).items() if k.split(".")[0] in HEAD_PARTS}
    assert set(want) == set(grads)
    for k, r in want.items():
        r = r.numpy()
        assert np.abs(grads[k].numpy() - r).max() <= 1e-3 * np.abs(r).max(), k

"""The training slice as a whole on the CPU: one detzero_tpu_torch Trainer
step (CenterPoint.loss, backward, clip, AdamW, schedule) at batch 2 against
the reference's CenterPoint.loss under jax.value_and_grad, at the tiny
geometry, f32, with the same weights and non-trivial BN statistics.

  * loss and every aux term within 1e-4 relative;
  * every gradient leaf of the 2D backbone and the head within
    1e-3 * max|ref leaf|, of the 3D backbone within 2e-2 * max|ref leaf|
    (the reference rounds the conv cotangent and its CPU weight gradient to
    bf16, the port the cotangent only);
  * the BN running statistics after the step within 1e-5 relative;
  * the unclipped gradient norm, the clip and the first update;
  * targets: integer targets equal, heatmaps within 1e-6; the head loss of
    both packages on the same head outputs.

The pillar budgets hold the whole cloud (2048/1024/512/256 instead of the
inference tests' 512/256/128/64).  With the smaller budgets the table keeps
only the first BEV rows, the BEV map is 81% exact zeros, and whole regions
of the 2D backbone carry duplicated activations; a ReLU decision shared by
such a region flips under f32 rounding, and the gradients of the first BEV
level then move by 1e-2 for a 1e-6 change of the weights, in either
package.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from detzero_tpu.core.config import Config
from detzero_tpu.models.detection import center_head as jch
from detzero_tpu.models.detection.centerpoint import CenterPoint as JaxCP
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.core.optim import build_optimizer
from detzero_tpu_torch.models.detection import center_head
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.parallel.trainer import Trainer

from test_torch_convert import CFG, KW, randomize_stats
from test_torch_optim import FLAGSHIP_OPT

torch.set_num_threads(1)

TRAIN_CFG = dict(CFG, VOXEL_CAPACITIES=(2048, 1024, 512, 256))
CLIP = FLAGSHIP_OPT["GRAD_NORM_CLIP"]

SIZES = np.array([[4.5, 2.0, 1.6], [0.9, 0.9, 1.7], [1.8, 0.8, 1.7]],
                 np.float32)


def make_batch(n=2, n_points=2048, m=8, n_valid=5, seed=0):
    """Points as the other tiny tests draw them; GT in the flagship's
    pattern: classes 0/1/2 in turn, class-typical sizes jittered by 20%,
    headings uniform, velocities in +-5 m/s, the first n_valid slots
    valid."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-6, 6, (n, n_points, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (n, n_points))
    grng = np.random.RandomState(seed + 1)
    cls = np.arange(m) % 3
    gb = np.zeros((n, m, 9), np.float32)
    gb[..., :2] = grng.uniform(-5.5, 5.5, (n, m, 2))
    gb[..., 2] = grng.uniform(-1, 1, (n, m))
    gb[..., 3:6] = SIZES[cls] * grng.uniform(0.8, 1.2, (n, m, 3))
    gb[..., 6] = grng.uniform(-np.pi, np.pi, (n, m))
    gb[..., 7:9] = grng.uniform(-5, 5, (n, m, 2))
    gv = np.zeros((n, m), bool)
    gv[:, :n_valid] = True
    return {"points": pts, "points_valid": np.ones((n, n_points), bool),
            "gt_boxes": gb, "gt_classes": np.tile(cls, (n, 1)).astype(
                np.int32), "gt_valid": gv}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def step():
    """The reference's loss, gradients and statistics, and one port Trainer
    step from the same weights (drawn by the port, converted to flax)."""
    batch = make_batch()
    model = CenterPoint(TRAIN_CFG, 3, dtype=torch.float32, device="cpu",
                        **KW)
    model.init_parameters(torch.Generator().manual_seed(0))
    v = randomize_stats(to_flax(model.state_dict()), 4)
    jm = JaxCP(Config(TRAIN_CFG), 3, dtype=jnp.float32, **KW)

    def lfn(params):
        loss, (aux, updates) = jm.loss(
            {"params": params, "batch_stats": v["batch_stats"]},
            batch["points"], batch["points_valid"], batch["gt_boxes"],
            batch["gt_classes"], batch["gt_valid"])
        return loss, (aux, updates)

    (loss, (aux, updates)), grads = jax.jit(jax.value_and_grad(
        lfn, has_aux=True))(v["params"])
    ref = {"loss": float(loss), "aux": jax.tree.map(np.asarray, aux),
           "grads": jax.tree.map(np.asarray, grads),
           "stats": jax.tree.map(np.asarray, updates["batch_stats"])}

    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    opt = build_optimizer(FLAGSHIP_OPT, 10, model)
    got = {"lr0": opt.lr,
           "params0": {k: p.detach().clone()
                       for k, p in model.named_parameters()}}
    trainer = Trainer(model, opt)
    got["loss"], got["aux"], got["gnorm"] = trainer.step(
        _torch_batch(batch))
    # the gradients as the optimizer saw them, after the clip
    got["grads"] = {k: p.grad for k, p in model.named_parameters()}
    return jm, v, batch, ref, model, trainer, got


def test_loss_and_aux(step):
    *_, ref, _, _, got = step
    assert abs(float(got["loss"]) - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    assert set(got["aux"]) == set(ref["aux"])
    for k, r in ref["aux"].items():
        assert r.shape == tuple(got["aux"][k].shape) == (2,), k
        assert np.abs(got["aux"][k].numpy() - r).max() \
            <= 1e-4 * np.abs(r).max(), k


def test_gradients(step):
    """The reference's gradients, scaled by the clip of its own norm, against
    the port's clipped gradients."""
    *_, ref, model, _, got = step
    ref_norm = float(optax.global_norm(ref["grads"]))
    assert abs(float(got["gnorm"]) - ref_norm) <= 1e-3 * ref_norm
    scale = 1.0 if ref_norm < CLIP else CLIP / ref_norm
    want = convert_centerpoint({"params": ref["grads"]}, model)
    assert set(want) == set(got["grads"])
    for k, r in want.items():
        g = got["grads"][k]
        assert g is not None, k
        tol = 2e-2 if k.startswith("backbone3d.") else 1e-3
        r = r.numpy() * scale
        assert np.abs(g.numpy() - r).max() <= tol * np.abs(r).max(), k
    # the 3D backbone trains: the stem's kernel gets a gradient
    assert float(got["grads"]["backbone3d.SparseConvBNReLU_0.kernel"].abs()
                 .max()) > 0


def test_bn_running_stats(step):
    *_, ref, model, _, _ = step
    want = convert_centerpoint({"params": {}, "batch_stats": ref["stats"]})
    buffers = dict(model.named_buffers())
    assert set(want) == set(buffers)
    for k, r in want.items():
        r = r.numpy()
        assert np.abs(buffers[k].numpy() - r).max() \
            <= 1e-5 * np.abs(r).max(), k
    # the step moved every statistic away from the loaded ones
    _, v, *_ = step
    before = convert_centerpoint({"params": {},
                                  "batch_stats": v["batch_stats"]})
    moved = sum(not torch.equal(before[k], buffers[k]) for k in before)
    assert moved == len(before)


def test_targets_and_head_loss(step):
    """assign_targets on the same GT: integer targets equal, heatmaps within
    1e-6; both packages' center_head_loss on the same head outputs."""
    jm, v, batch, *_ = step
    kw = dict(class_ids_each_head=jm.class_ids_each_head, hw=jm.bev_hw,
              feature_map_stride=jm.feature_map_stride,
              voxel_size=jm.voxel_size, pc_range=jm.pc_range,
              max_objs=jm.max_objs)
    ref_t = jax.jit(jax.vmap(lambda b, c, g: jch.assign_targets(
        b, c, g, **kw)))(batch["gt_boxes"], batch["gt_classes"],
                         batch["gt_valid"])
    tb = _torch_batch(batch)
    got_t = center_head.assign_targets(tb["gt_boxes"], tb["gt_classes"],
                                       tb["gt_valid"], **kw)
    for r, g in zip(ref_t, got_t):
        assert np.array_equal(np.asarray(r["inds"]), g["inds"].numpy())
        assert np.array_equal(np.asarray(r["mask"]), g["mask"].numpy())
        assert np.abs(np.asarray(r["heatmap"]) - g["heatmap"].numpy()).max() \
            <= 1e-6
        assert np.abs(np.asarray(r["anno_box"]) - g["anno_box"].numpy()) \
            .max() <= 1e-5
    assert sum(int(g["mask"].sum()) for g in got_t) == 10
    assert all(float(g["heatmap"].max()) == 1.0 for g in got_t)

    # the same head outputs (the port's, in eval mode) through both losses
    model = step[4]
    with torch.no_grad(), model._mode(False):
        tp, _ = model.network(*model.prepare(tb["points"],
                                             tb["points_valid"]))
    preds = [{k: np.asarray(x) for k, x in h.items()} for h in tp]
    lkw = dict(hw=jm.bev_hw, feature_map_stride=jm.feature_map_stride,
               voxel_size=jm.voxel_size, pc_range=jm.pc_range)
    ref_l, ref_aux = jax.jit(jax.vmap(lambda p, t: jch.center_head_loss(
        p, t, **lkw)))(preds, ref_t)
    got_l, got_aux = center_head.center_head_loss(tp, got_t, **lkw)
    assert np.abs(got_l.numpy() - np.asarray(ref_l)).max() \
        <= 1e-5 * np.abs(np.asarray(ref_l)).max()
    for k, r in ref_aux.items():
        r = np.asarray(r)
        assert np.abs(got_aux[k].numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_trainer_step(step):
    """The first AdamW step moves every element by at most lr (plus the
    decay; 1e-4 relative for the float32 rounding of the parameter), moves
    nearly every parameter (an L1 bias gradient can cancel to exactly 0),
    and the schedule advances."""
    *_, trainer, got = step
    lr0 = got["lr0"]
    assert trainer.step_count == 1 and trainer.optimizer.lr > lr0
    n_moved = 0
    for k, p in trainer.model.named_parameters():
        before = got["params0"][k]
        moved = float((p.detach() - before).abs().max())
        assert moved <= lr0 * (1 + 1e-2 * float(before.abs().max())) \
            * (1 + 1e-4), k
        n_moved += moved > 0
    assert n_moved >= 0.95 * len(got["params0"])

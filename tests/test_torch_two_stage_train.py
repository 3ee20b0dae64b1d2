"""The two-stage training loss of detzero_tpu_torch against the reference's
CenterPoint.loss under jax.value_and_grad on the CPU: batch 2, the tiny
geometry with pillar budgets that hold the whole cloud (as
tests/test_torch_train_step.py), SECOND_STAGE with ROI_BUDGET 16,
ROI_GRID_SIZE 3 and ROI_ATTENTION, float32, the same weights and the same
random draws of the RoI subsample (the reference's `jax.random` draws from
one key, handed to the port).  The GT boxes are jittered copies of the
proposals, so the subsample holds foreground RoIs and every term of the
RoI loss is live.

  * the loss and every aux term within 1e-4 relative;
  * every gradient leaf of `roi_head`: at most 1e-3 of a leaf's elements
    beyond 1e-3 * max|ref leaf| + 1e-6 (float32 throughout; an element
    past it is a max-pool or ReLU decision flipped by rounding; the 1e-6
    floor holds the two leaves whose gradient is zero in exact arithmetic,
    the LayerNorm bias, which the BN after it cancels, and the attention's
    key bias, which the softmax cancels, where rounding leaves ~2e-7 in
    either package); the first stage's
    leaves as tests/test_torch_train_step.py bounds them, which also shows
    that the RoI loss sends no gradient into the first stage;
  * the RoI head's BN running statistics after the step within 1e-5
    relative.
"""

import numpy as np
import pytest

import jax
import torch

from detzero_tpu_torch.convert import convert_centerpoint
from detzero_tpu_torch.ops import iou_bev

from test_torch_pdv_head import _jax_draws
from test_torch_train_step import TRAIN_CFG, make_batch
from test_torch_two_stage import TWO_STAGE, two_stage_models

torch.set_num_threads(1)

CFG2 = dict(TRAIN_CFG, **TWO_STAGE)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def step():
    model, v, jm = two_stage_models(CFG2, 4)
    batch = make_batch()
    tb = {k: _t(a) for k, a in batch.items()}
    # GT: five of the eight slots are jittered copies of train-mode proposals
    stats = {k: b.clone() for k, b in model.named_buffers()}
    with torch.no_grad(), model._mode(True):
        _, roi = model.network(*model.prepare(tb["points"],
                                              tb["points_valid"]))
        for k, b in model.named_buffers():
            b.copy_(stats[k])
    rng = np.random.RandomState(3)
    gb = batch["gt_boxes"]
    gb[:, :5, :7] = roi["rois"].numpy()[:, [0, 3, 6, 9, 12]] \
        + rng.randn(2, 5, 7).astype(np.float32) * 0.05
    gb[:, :5, 3:6] = np.abs(gb[:, :5, 3:6]) + 0.1
    tb["gt_boxes"] = _t(gb)
    key = jax.random.PRNGKey(3)
    draws = [_jax_draws(k, 16, 16) for k in jax.random.split(key, 2)]
    roi_draws = (_t(np.stack([u for u, _ in draws])),
                 _t(np.stack([d for _, d in draws])))

    def lfn(params):
        return jm.loss({"params": params, "batch_stats": v["batch_stats"]},
                       batch["points"], batch["points_valid"], gb,
                       batch["gt_classes"], batch["gt_valid"], rng=key)

    (loss, (aux, updates)), grads = jax.jit(jax.value_and_grad(
        lfn, has_aux=True))(v["params"])
    ref = {"loss": float(loss), "aux": jax.tree.map(np.asarray, aux),
           "grads": convert_centerpoint(
               {"params": jax.tree.map(np.asarray, grads)}, model),
           "stats": convert_centerpoint(
               {"params": {}, "batch_stats": jax.tree.map(
                   np.asarray, updates["batch_stats"])})}
    n0 = iou_bev.OVERLAP_LAUNCHES
    got_loss, got_aux = model.loss(**tb, roi_draws=roi_draws)
    got_loss.backward()
    assert iou_bev.OVERLAP_LAUNCHES == n0       # CPU: the plain version
    return model, ref, float(got_loss.detach()), got_aux


def test_two_stage_loss_and_aux(step):
    _, ref, loss, aux = step
    assert abs(loss - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    assert set(aux) == set(ref["aux"])
    assert {"roi_cls", "roi_reg", "roi_corner"} <= set(aux)
    for k, r in ref["aux"].items():
        g = aux[k].detach().numpy()
        assert g.shape == r.shape == (2,), k
        assert np.abs(g - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-3), k
    # foreground RoIs were drawn: the regression terms are live
    assert (ref["aux"]["roi_reg"] > 0).all()
    assert (ref["aux"]["roi_corner"] > 0).all()


def test_two_stage_gradients(step):
    model, ref, *_ = step
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(ref["grads"])
    n_roi = 0
    for k, r in ref["grads"].items():
        g = grads[k]
        assert g is not None, k
        r, g = r.numpy(), g.numpy()
        if k.startswith("roi_head."):
            n_roi += 1
            bound = 1e-3 * np.abs(r).max() + 1e-6
            n_out = int((np.abs(g - r) > bound).sum())
            assert n_out <= 1e-3 * r.size, (k, n_out, r.size)
        else:
            tol = 2e-2 if k.startswith("backbone3d.") else 1e-3
            assert np.abs(g - r).max() <= tol * np.abs(r).max(), k
    assert n_roi == sum(k.startswith("roi_head.") for k in grads) > 30
    assert float(grads["roi_head.reg.weight"].abs().max()) > 0
    assert float(grads["roi_head.grid_attn.query.kernel"].abs().max()) > 0


def test_roi_head_running_stats(step):
    model, ref, *_ = step
    buffers = dict(model.named_buffers())
    roi_stats = {k: r for k, r in ref["stats"].items()
                 if k.startswith("roi_head.")}
    assert len(roi_stats) == 12
    for k, r in roi_stats.items():
        r = r.numpy()
        assert np.abs(buffers[k].numpy() - r).max() \
            <= 1e-5 * np.abs(r).max(), k

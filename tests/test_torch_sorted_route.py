"""`BACKBONE3D: sorted`: the port runs it on its row-pad backbone
(models/detection/centerpoint.py, `_BACKBONES`), the reference on the
voxel route (models/detection/backbone3d.py over ops/voxelize.py and
ops/sparse.py, and in the second stage ops/pointnet2.py).  Here the port's
`sorted` is held to the reference's `sorted` as tests/test_pillars.py:
171-230 holds the reference's pillar route to it: its geometry (an 8 x 32
x 32 grid of 0.4 x 0.4 x 0.5 m, 400 points a sample, capacities
1024/512/256/128), its weights (the reference's init from PRNGKey(0),
carried across by convert.py) and its tolerances, float32:

  * the one-stage forward: every head output within 2e-3 (rtol and atol);
  * the batch-2 loss within 1e-4, and every gradient leaf within 2e-3 of
    its leaf's scale max(max|leaf|, 1e-3), but the 3D backbone's;
  * the 3D backbone's gradient leaves within 2e-2 of their scale: the
    port's bound against the reference there (tests/
    test_torch_train_step.py; float32 summation order through the sparse
    convs), which it meets against the reference's pillar route alike;
    no farther from the reference's sorted route than from its pillar
    route, so what remains is the backbone's arithmetic, not the route;
  * the two-stage predict: boxes and scores within 2e-3.

The port's `sorted` keeps every pillar of a row (its row budget is the L0
row width), as the voxel route keeps every voxel.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.core.config import Config
from detzero_tpu.models.detection.centerpoint import CenterPoint as JaxCP
from detzero_tpu_torch.convert import convert_centerpoint
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

torch.set_num_threads(1)

VS = (0.4, 0.4, 0.5)
RANGE = (-6.4, -6.4, -2.0, 6.4, 6.4, 2.0)
KW = dict(pc_range=RANGE, voxel_size=VS, max_voxels=1024, max_points=600,
          max_objs=8)
CFG = {"WITH_VELOCITY": True, "WITH_IOU": True,
       "CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
       "VOXEL_CAPACITIES": (1024, 512, 256, 128), "BACKBONE3D": "sorted"}
CFG2 = dict(CFG, SECOND_STAGE=True, ROI_BUDGET=16, ROI_GRID_SIZE=3)


def parity_inputs(b=2, n=400):
    """tests/test_pillars.py's _parity_inputs."""
    rng = np.random.RandomState(7)
    pts = rng.uniform(-6.3, 6.3, (b, n, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.9, 1.9, (b, n))
    pv = rng.rand(b, n) > 0.05
    gb = np.zeros((b, 8, 9), np.float32)
    gb[:, 0, :7] = [1, 1, 0, 3.8, 1.8, 1.5, 0.4]
    gb[:, 1, :7] = [-2, 2, 0.2, 0.8, 0.8, 1.7, -0.8]
    gc = np.zeros((b, 8), np.int32)
    gc[:, 1] = 1
    gv = np.zeros((b, 8), bool)
    gv[:, :2] = True
    return pts, pv, gb, gc, gv


@functools.lru_cache(maxsize=None)
def models(two_stage):
    """The port's model and the reference's sorted and pillar models (of
    CFG2 or CFG), on the reference's init of the pillar model from
    PRNGKey(0) (as tests/test_pillars.py draws them; its sorted model has
    the same param tree, which that file asserts)."""
    cfg = CFG2 if two_stage else CFG
    pts, pv, *_ = parity_inputs()
    jp = JaxCP(Config(dict(cfg, BACKBONE3D="pillar")), 3, dtype=jnp.float32,
               **KW)
    js = JaxCP(Config(cfg), 3, dtype=jnp.float32, **KW)
    assert js.backend == "sorted"
    v = jax.tree.map(np.asarray, jp.init(jax.random.PRNGKey(0), pts, pv))
    model = CenterPoint(cfg, 3, dtype=torch.float32, device="cpu", **KW)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    return model, v, js, jp


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def test_forward_equals_reference_sorted():
    pts, pv, *_ = parity_inputs()
    model, v, jm, _ = models(False)
    preds, _, _ = jax.jit(lambda v_, p, q: jm.apply(
        v_, p, q, train=False, mutable_stats=False))(v, pts, pv)
    for i in range(len(pts)):
        got = model.forward_one(torch.from_numpy(pts[i]),
                                torch.from_numpy(pv[i]))
        for ref_h, got_h in zip(preds, got):
            assert ref_h.keys() == got_h.keys()
            for k in ref_h:
                _close(got_h[k].numpy(), np.asarray(ref_h[k])[i], 2e-3, k)


def test_loss_and_gradients_equal_reference_sorted():
    pts, pv, gb, gc, gv = parity_inputs()
    model, v, js, jp = models(False)
    model.zero_grad()

    def grads(jm):
        def loss_of(params):
            loss, _ = jm.loss({"params": params,
                               "batch_stats": v["batch_stats"]},
                              pts, pv, gb, gc, gv)
            return loss

        loss, g = jax.jit(jax.value_and_grad(loss_of))(v["params"])
        return float(loss), convert_centerpoint(
            {"params": jax.tree.map(np.asarray, g)}, model)

    ref_loss, want = grads(js)
    _, pillar = grads(jp)
    loss, _ = model.loss(*(torch.from_numpy(a) for a in (pts, pv, gb, gc,
                                                         gv)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-4,
                               atol=1e-4)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, r in want.items():
        g = got[k].grad
        assert g is not None, k
        scale = max(float(r.abs().max()), 1e-3)
        if not k.startswith("backbone3d."):
            _close(g.numpy() / scale, r.numpy() / scale, 2e-3, k)
            continue
        err = float((g - r).abs().max()) / scale
        err_pillar = float((g - pillar[k]).abs().max()) / scale
        assert err <= 2e-2, (k, err)
        assert err <= err_pillar + 2e-3, (k, err, err_pillar)


def test_two_stage_predict_equals_reference_sorted():
    pts, pv, *_ = parity_inputs()
    model, v, jm, _ = models(True)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda v_, p, q: jm.predict(v_, p, q))(v, pts, pv))
    got = model.predict(torch.from_numpy(pts), torch.from_numpy(pv))
    assert ref["mask"].any()
    np.testing.assert_array_equal(got["mask"].numpy(), ref["mask"])
    for k in ("boxes", "scores"):
        _close(got[k].numpy(), ref[k], 2e-3, k)

"""Ranks for the data-parallel CPU tests (tests/test_torch_dist*.py):
`spawn` starts `world` processes that join a gloo group through a file
under the test's tmp_path (no port is shared between pytest workers), run
one of the worker functions below and hand back what it returns.  This
module imports torch, numpy and the port only, so each rank starts
without jax."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as tmp_mp
from torch import nn

from detzero_tpu_torch.core import mesh
from detzero_tpu_torch.core.optim import build_optimizer
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.models.layers import MaskedBatchNorm
from detzero_tpu_torch.parallel.trainer import Trainer, eval_gather

SPAWN_TIMEOUT_S = 240.0
# tests/test_torch_train_step.py's tiny geometry (TRAIN_CFG, KW) with one
# BEV layer a level and 32 pillars a BEV row, for time
TINY_CFG = {"WITH_VELOCITY": True, "WITH_IOU": True,
            "CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
            "VOXEL_CAPACITIES": (2048, 1024, 512, 256),
            "BACKBONE3D": "pillar_pallas", "BEV_LAYER_NUMS": (1, 1),
            "PILLAR_ROW_BUDGET": 32}
TINY_KW = dict(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 2.0),
               voxel_size=(0.2, 0.2, 0.5), max_voxels=512, max_points=2048,
               max_objs=8)
# OPTIMIZATION of configs/det_model_cfgs/centerpoint_5sweeps.yaml
OPT = {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
       "GRAD_NORM_CLIP": 10.0, "PCT_START": 0.4, "DIV_FACTOR": 10}
SIZES = np.array([[4.5, 2.0, 1.6], [0.9, 0.9, 1.7], [1.8, 0.8, 1.7]],
                 np.float32)
# masked BN cases: (name, input shape, channel dim, masked)
BN_CASES = (("masked_last", (4, 6, 5, 8), -1, True),
            ("rows_last", (4, 6, 5, 8), -1, False),
            ("nchw", (4, 8, 6, 5), 1, False))


def _child(rank, world, tmp, fn_name, args):
    torch.set_num_threads(1)
    mesh.init_distributed(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world)
    try:
        out = globals()[fn_name](rank, world, Path(tmp), *args)
        torch.save(out, Path(tmp) / f"out_{rank}.pt")
        mesh.barrier()
    finally:
        mesh.shutdown()


def spawn(fn_name, world, tmp, *args, timeout_s=SPAWN_TIMEOUT_S):
    """Runs worker `fn_name`(rank, world, tmp, *args) on `world` spawned
    gloo ranks; returns their results in rank order.  A rank that raises
    fails the call with its traceback; one that hangs, after
    `timeout_s`."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = tmp_mp.start_processes(_child, args=(world, str(tmp), fn_name,
                                               args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn_name} on {world} ranks outlasted "
                               f"{timeout_s} s")
    return [torch.load(tmp / f"out_{r}.pt", weights_only=False)
            for r in range(world)]


# ----------------------------------------------------------------------
# the masked BN


def bn_inputs(shape, ch, masked, seed=0):
    """x, mask (or None) and the loss weights w of one BN case."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 1.5 + 0.3).astype(np.float32))
    w = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    mask = None
    if masked:
        mshape = [1 if d == ch % len(shape) else s
                  for d, s in enumerate(shape)]
        mask = torch.from_numpy(rng.rand(*mshape) > 0.4)
    return x, mask, w


def bn_run(x, mask, w, ch, seed=1):
    """Train-mode MaskedBatchNorm with seeded affine on x; loss sum(w y).
    Returns y, the input gradient, the scale and bias gradients and the
    running statistics."""
    c = x.shape[ch]
    bn = MaskedBatchNorm(c)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.scale.copy_(1 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
    bn.train()
    x = x.clone().requires_grad_(True)
    y = bn(x, channel_dim=ch, mask=mask)
    (y * w).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dscale": bn.scale.grad,
            "dbias": bn.bias.grad, "mean": bn.mean.clone(),
            "var": bn.var.clone()}


def bn_cases(rank, world, tmp):
    """Every BN_CASES case on this rank's slice of the batch axis."""
    out = {}
    for name, shape, ch, masked in BN_CASES:
        x, mask, w = bn_inputs(shape, ch, masked)
        n = shape[0] // world
        sl = slice(rank * n, (rank + 1) * n)
        out[name] = bn_run(x[sl], None if mask is None else mask[sl], w[sl],
                           ch)
    return out


# ----------------------------------------------------------------------
# a toy model with a masked BN, for the trainer's own logic


class ToyModel(nn.Module):
    """Linear -> MaskedBatchNorm -> ReLU -> Linear; `loss(x, y)` is the
    mean over samples of each sample's squared error, the form of
    CenterPoint.loss, so averaged rank gradients are the global batch's."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        # no bias before the BN, which would cancel its gradient to noise
        self.fc1 = nn.Linear(4, 16, bias=False)
        self.bn = MaskedBatchNorm(16)
        self.fc2 = nn.Linear(16, 1)
        with torch.no_grad():
            for p in (self.fc1.weight, self.fc2.weight, self.fc2.bias):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)

    def loss(self, x, y, generator=None):
        h = torch.relu(self.bn(self.fc1(x), mask=(x[..., :1] > -1.5)))
        per = ((self.fc2(h)[..., 0] - y) ** 2).mean(-1)
        return per.mean(), {"mse": per}


def toy_batches(n, batch=4, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(batch, 5, 4).astype(np.float32)
        out.append({"x": x, "y": (x.sum(-1) * 0.5).astype(np.float32)})
    return out


def toy_trainer(ckpt_dir=None, steps_per_call=1, log_every=1, seed=0):
    """SGD with momentum: its update is linear in the gradient, so float32
    summation order stays at rounding level over steps (Adam turns the
    sign of a near-zero gradient element into +-lr)."""
    model = ToyModel(seed)
    opt = build_optimizer({"OPTIMIZER": "sgd", "LR": 0.05, "MOMENTUM": 0.9,
                           "DECAY_STEP_LIST": [], "LR_DECAY": 0.1}, 8, model)
    return Trainer(model, opt, ckpt_dir=ckpt_dir, log_every=log_every,
                   steps_per_call=steps_per_call, prefetch=0)


def toy_fit(rank, world, tmp, n_steps=4, batch=4):
    """fit on this rank's slices of toy_batches, with a checkpoint
    directory; after every step the ranks must be bit-equal.  Returns
    the state, the step results and the per-step mismatches."""
    trainer = toy_trainer(ckpt_dir=tmp / "ckpt")
    steps = []
    step = trainer.step

    def checked(b):
        res = step(b)
        steps.append([t.clone() for t in (res[0], res[2])])
        steps[-1].append(trainer.replica_mismatch())
        return res

    trainer.step = checked
    n = batch // world
    parts = [{k: v[rank * n:(rank + 1) * n] for k, v in b.items()}
             for b in toy_batches(n_steps, batch)]
    trainer.fit(iter(parts), n_steps)
    return {"state": trainer.state_dict(), "steps": steps}


def misc(rank, world, tmp):
    """eval_gather of per-rank lists, broadcast_object and make_mesh."""
    m = mesh.make_mesh()
    return {"gather": eval_gather([f"r{rank}-{i}" for i in range(rank + 1)]),
            "bcast": mesh.broadcast_object({"rank": rank}),
            "mesh": (m.rank, m.world),
            "rng": mesh.rank_rng(3).randint(1 << 30, size=4),
            "seed": mesh.rank_seed(5)}


# ----------------------------------------------------------------------
# the tiny CenterPoint


def tiny_batch(n=2, n_points=2048, m=8, n_valid=5, seed=0):
    """tests/test_torch_train_step.py's make_batch."""
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


def tiny_steps(rank, world, tmp, n_steps=2, batch=2, device="cpu",
               starts=None):
    """n_steps Trainer steps of the tiny float32 CenterPoint on this rank's
    slices of tiny_batch(batch, seed=step); after each: the loss, aux,
    gnorm, every (averaged, clipped) gradient, the BN running statistics,
    the trainer's state and the ranks' mismatches.  With world 1 and no
    group it is the single process; `starts[s]`, when given, is the
    trainer state step s starts from (another run's, so that each step is
    compared from equal weights: Adam turns float32 rounding of near-zero
    gradient elements into +-lr)."""
    model = CenterPoint(TINY_CFG, 3, dtype=torch.float32, device="cpu",
                        **TINY_KW)
    model.init_parameters(torch.Generator().manual_seed(0))
    model = model.to(device)
    trainer = Trainer(model, build_optimizer(OPT, 10, model), seed=7)
    n = batch // world
    out = []
    for s in range(n_steps):
        if starts is not None and starts[s] is not None:
            model.load_state_dict(starts[s]["model"])
            trainer.optimizer.load_state_dict(starts[s])
            trainer.step_count = starts[s]["step"]
        b = {k: v[rank * n:(rank + 1) * n]
             for k, v in tiny_batch(batch, seed=s).items()}
        loss, aux, gnorm = trainer.step(trainer.to_device(b))
        out.append({"loss": loss.cpu(), "gnorm": gnorm.cpu(),
                    "aux": {k: v.cpu() for k, v in aux.items()},
                    "grads": {k: p.grad.detach().cpu().clone()
                              for k, p in model.named_parameters()},
                    "buffers": {k: v.detach().cpu().clone()
                                for k, v in model.named_buffers()},
                    "state": _cpu_copy(trainer.state_dict()),
                    "mismatch": trainer.replica_mismatch()})
    return out


def _cpu_copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return tree


# ----------------------------------------------------------------------
# the entry points


def train_then_test(rank, world, tmp, train_argv, test_argv):
    """train_det.main(train_argv) then test_det.main(test_argv +
    --data_parallel) on this rank; returns the trainer's step, state and
    mismatches, and test_det's result (None on ranks > 0)."""
    import sys

    from detzero_tpu_torch.tools import test_det, train_det

    # no TensorBoard: importing it loads TensorFlow here (12 s)
    sys.modules["torch.utils.tensorboard"] = None
    trainer = train_det.main(train_argv)
    state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    out = {"step": trainer.step_count, "state": state,
           "mismatch": trainer.replica_mismatch(),
           "logfiles": sorted(p.name for p in trainer.ckpt.ckpt_dir.parent
                              .glob("log_*"))}
    # every rank lists the logs before rank 0's test_det writes its own
    mesh.barrier()
    del trainer
    res = test_det.main(["--data_parallel"] + test_argv)
    out["test"] = None if res is None else {
        "det_annos": res["det_annos"], "path": str(res["result_path"]),
        "samples": res["timings"]["samples"]}
    return out

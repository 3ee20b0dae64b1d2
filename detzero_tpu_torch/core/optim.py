"""Optimizers and learning-rate schedules (port of detzero_tpu/core/optim.py).

The reference chains optax transforms: clip_by_global_norm, then AdamW (or
SGD) with weight decay masked by `wd_mask`, scaled by the schedule.  Here
`build_optimizer` returns an `Optimizer`: a torch optimizer with two
parameter groups (decayed and not), a LambdaLR that evaluates the
reference's schedule, and optax's clipping rule, which scales the gradients
by max_norm / norm only when norm >= max_norm (torch's clip_grad_norm_
divides by norm + 1e-6 and would differ).  The Adam family is `AdamW` below,
optax's `scale_by_adam` step for step: optax's bias corrections raise the
float32 betas to the step count, while its moments use 1 - beta in double,
which makes its update 6.4e-6 smaller than torch.optim.AdamW's at b2 0.999.

The schedules are evaluated in float32 in optax's order of operations, with
the C library's single-precision cosine (the one XLA's CPU backend calls),
so the learning rate of every step is optax's to the bit.
`optax.cosine_onecycle_schedule` is not torch's OneCycleLR, whose phases and
momentum cycling differ.

PARAMWISE (`custom_keys` of lr_mult and decay_mult) splits the parameters
into groups by their multipliers.  A key matches as a substring of the
parameter's flax path (`convert.flax_path`: `kernel` for `weight`), the
longest key winning, so one config gives the same multipliers in both
packages.  As in the reference's chain (scale_by_adam, decay, learning
rate, lr_mult), a group's update is -lr * lr_mult * (Adam direction +
WEIGHT_DECAY * decay_mult * p), the decay only where `wd_mask` allows it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Any, Mapping

import numpy as np
import torch

from detzero_tpu_torch.convert import flax_path


def wd_mask(names):
    """{parameter name: receives weight decay}.  No decay for biases and
    norm scales or offsets (leaf `bias`, `scale`, `mean`, `var`, a leaf
    containing 'bn', or anything under a *BatchNorm* / *LayerNorm* parent),
    as the reference's mask decides on the flax path."""
    out = {}
    for name in names:
        leaf = name.rsplit(".", 1)[-1]
        out[name] = not (leaf in ("bias", "scale", "mean", "var")
                         or "BatchNorm" in name or "LayerNorm" in name
                         or "bn" in leaf)
    return out


@functools.lru_cache(maxsize=None)
def _cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


_f32 = np.float32


def build_schedule(opt_cfg: Mapping[str, Any], total_steps: int):
    """step -> learning rate (a float), as optax evaluates the reference's
    schedule in float32: `cosine_onecycle_schedule` for *_onecycle
    optimizers, `piecewise_constant_schedule` otherwise."""
    lr = float(opt_cfg["LR"])
    if opt_cfg["OPTIMIZER"].endswith("onecycle"):
        div = float(opt_cfg.get("DIV_FACTOR", 10.0))
        pct_start = float(opt_cfg.get("PCT_START", 0.4))
        if total_steps <= 0:
            raise ValueError("the onecycle schedule needs total_steps > 0")
        # optax.piecewise_interpolate_schedule('cosine', lr / div, ...)
        bounds = [0, int(pct_start * total_steps), int(total_steps)]
        # final_div_factor is DIV_FACTOR * 1e3, as the reference sets it
        values = np.cumprod([lr / div, div, 1.0 / (div * (div * 1e3))])

        def onecycle(count: int) -> float:
            out = _f32(0.0)
            for i in range(2):
                if not bounds[i] <= count < bounds[i + 1]:
                    continue
                pct = _f32(count - bounds[i]) / _f32(bounds[i + 1]
                                                     - bounds[i])
                start, end = values[i], values[i + 1]
                cos = _f32(_cosf()(_f32(math.pi) * pct))
                out = _f32(end) + _f32((start - end) / 2.0) * (cos + _f32(1))
            if bounds[-1] <= count:
                out = out + _f32(values[-1])
            return float(out)

        return onecycle
    steps = [int(total_steps * x)
             for x in opt_cfg.get("DECAY_STEP_LIST", [0.7, 0.9])]
    decay = float(opt_cfg.get("LR_DECAY", 0.1))

    def piecewise(count: int) -> float:
        v = _f32(lr)
        for threshold in sorted(steps):
            if count >= threshold:
                v = _f32(decay) * v
        return float(v)

    return piecewise


def global_norm(tensors):
    """sqrt of the sum of squares of every element, in float32 (optax)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def clip_by_global_norm_(tensors, norm, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: t / norm * max_norm unless
    norm < max_norm.  No host synchronisation."""
    keep = norm < max_norm
    for t in tensors:
        t.copy_(torch.where(keep, t, t / norm.to(t.dtype) * max_norm))


def paramwise_multipliers(names, paramwise_cfg):
    """{parameter name: (lr_mult, decay_mult)} from PARAMWISE.custom_keys
    (the reference's add_params, optimize_utils/__init__.py:81-137): the
    longest custom key that is a substring of the parameter's dotted flax
    path wins; unmatched parameters get (1, 1).  Keys and values accept
    either case (lr_mult/LR_MULT).  `names` are (name, ndim) pairs."""
    custom = dict(paramwise_cfg.get("custom_keys",
                                    paramwise_cfg.get("CUSTOM_KEYS", {}))
                  or {})
    sorted_keys = sorted(sorted(custom.keys()), key=len, reverse=True)
    out = {}
    for name, ndim in names:
        dotted = ".".join(flax_path(name, ndim)[1])
        out[name] = (1.0, 1.0)
        for k in sorted_keys:
            if k in dotted:
                c = custom[k]
                out[name] = (float(c.get("lr_mult", c.get("LR_MULT", 1.0))),
                             float(c.get("decay_mult",
                                         c.get("DECAY_MULT", 1.0))))
                break
    return out


class AdamW(torch.optim.Optimizer):
    """optax.adamw (eps_root 0, no Nesterov) as a torch optimizer, with
    optax's order of operations and float32 constants; a group's
    `weight_decay` is added to the Adam direction before the learning rate
    scales it (decoupled decay), and its `lr_mult` (PARAMWISE) scales the
    update after the learning rate."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, lr_mult=1.0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
            count = states[0]["count"]
            grads = [p.grad for p in params]
            mus = [st["mu"] for st in states]
            nus = [st["nu"] for st in states]
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            bc1 = float(1 - _f32(b1) ** _f32(count))
            bc2 = float(1 - _f32(b2) ** _f32(count))
            den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(mus, bc1), den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(
                    params, group["weight_decay"]))
            lr = float(_f32(group["lr"]))
            upd = torch._foreach_mul(upd, -lr)
            if group["lr_mult"] != 1.0:
                torch._foreach_mul_(upd, group["lr_mult"])
            torch._foreach_add_(params, upd)


class Optimizer:
    """One optimizer step of the reference's optax chain: global-norm clip,
    update, schedule.  `step` returns the global norm of the unclipped
    gradients, which the reference's trainer reports."""

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler,
                 grad_norm_clip: float):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.grad_norm_clip = float(grad_norm_clip)

    @property
    def params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @property
    def lr(self) -> float:
        """The learning rate the next `step` applies."""
        return self.optimizer.param_groups[0]["lr"]

    def state_dict(self):
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state) -> None:
        """Restore `state_dict()`'s output.  The next step's learning rate
        comes from this optimizer's own schedule at the restored step count
        (its total steps may differ from the saved run's), as optax
        evaluates the reference's schedule at the restored count."""
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        step = self.scheduler.last_epoch
        for group, base, fn in zip(self.optimizer.param_groups,
                                   self.scheduler.base_lrs,
                                   self.scheduler.lr_lambdas):
            group["lr"] = base * fn(step)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        params = self.params
        for p in params:
            # optax updates every leaf, a zero gradient included
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if self.grad_norm_clip > 0:
            clip_by_global_norm_(grads, norm, self.grad_norm_clip)
        self.optimizer.step()
        self.scheduler.step()
        return norm


def build_optimizer(opt_cfg: Mapping[str, Any], total_steps: int,
                    model: torch.nn.Module) -> Optimizer:
    """The reference's build_optimizer for `model`'s parameters: 'adam' and
    'adam_onecycle' are `AdamW` with b2 0.99, 'adamW' and 'adamW_onecycle'
    with b2 0.999 (b1 0.9, eps 1e-8), 'sgd' torch's SGD with MOMENTUM
    (optax's trace); weight decay WEIGHT_DECAY on the `wd_mask` parameters;
    GRAD_NORM_CLIP > 0 clips by global norm; PARAMWISE groups the Adam
    family's parameters by their multipliers (`paramwise_multipliers`) and
    is refused with 'sgd', as the reference refuses it."""
    name = opt_cfg["OPTIMIZER"]
    lr = float(opt_cfg["LR"])
    wd = float(opt_cfg.get("WEIGHT_DECAY", 0.0))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    mask = wd_mask(n for n, _ in named)
    paramwise = opt_cfg.get("PARAMWISE")
    if paramwise and name == "sgd":
        raise NotImplementedError(
            "PARAMWISE with OPTIMIZER sgd is not supported")
    mults = paramwise_multipliers(((n, p.ndim) for n, p in named),
                                  paramwise) if paramwise else {}
    # one group per (lr_mult, weight decay): without PARAMWISE, the decayed
    # parameters and the rest
    keyed = {}
    for n, p in named:
        lr_mult, decay_mult = mults.get(n, (1.0, 1.0))
        keyed.setdefault((lr_mult, wd * decay_mult if mask[n] else 0.0),
                         []).append(p)
    groups = [{"params": ps, "lr_mult": k[0], "weight_decay": k[1]}
              for k, ps in keyed.items()]
    if name in ("adam", "adam_onecycle", "adamW", "adamW_onecycle"):
        b2 = 0.99 if name in ("adam", "adam_onecycle") else 0.999
        opt = AdamW(groups, lr=lr, betas=(0.9, b2), eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(groups, lr=lr,
                              momentum=float(opt_cfg.get("MOMENTUM", 0.9)))
    else:
        raise NotImplementedError(name)
    schedule = build_schedule(opt_cfg, total_steps)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / lr)
    return Optimizer(opt, sched, float(opt_cfg.get("GRAD_NORM_CLIP", 0.0)))

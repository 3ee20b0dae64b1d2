"""The training step (single-device port of
detzero_tpu/parallel/trainer.Trainer.step): loss, backward, gradient global
norm and clip, optimizer and schedule step; the model updates its BN
running statistics in the forward.  Checkpoints, data parallelism,
prefetching and several steps per call are not ported yet."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from detzero_tpu_torch.core.optim import Optimizer


class Trainer:
    """Owns a model and its `Optimizer`.  `model.loss(**batch)` returns
    (loss, aux dict)."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer):
        self.model = model
        self.optimizer = optimizer
        self.step_count = 0

    def step(self, batch: Mapping[str, Any]):
        """One optimizer step on `batch` (the keyword arguments of
        `model.loss`).  Returns (loss, aux, gnorm) as detached tensors on
        the model's device, gnorm before clipping; nothing waits for the
        device."""
        loss, aux = self.model.loss(**batch)
        self.optimizer.zero_grad()
        loss.backward()
        gnorm = self.optimizer.step()
        self.step_count += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, gnorm

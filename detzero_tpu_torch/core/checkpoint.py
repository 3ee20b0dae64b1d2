"""Checkpoints as torch files, with the reference's resume semantics (port of
detzero_tpu/core/checkpoint.py, which writes orbax; reference:
train_utils.py:136-202, model_utils.py:8-72).

One file a step, `<ckpt_dir>/ckpt_<step>.pt`, holding {"model": the model's
state_dict, "optimizer": the torch optimizer's state_dict, "scheduler": the
schedule's state_dict, "step": step}, every tensor on the CPU.  A save
writes a temporary file and renames it, so a reader never sees half a
checkpoint; the newest `max_to_keep` survive.  Files are read with
`torch.load(weights_only=True)`: tensors, numbers, strings and containers.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, ckpt_dir, max_to_keep: int = 5):
        self.ckpt_dir = Path(ckpt_dir).absolute()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def path(self, step: int) -> Path:
        return self.ckpt_dir / f"ckpt_{int(step)}.pt"

    def all_steps(self):
        return sorted(int(m.group(1)) for p in self.ckpt_dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state):
        """Write `state` (a dict of tensors, numbers and containers; tensors
        are copied to the CPU) as the checkpoint of `step`, then drop all
        but the newest `max_to_keep`."""
        path = self.path(step)
        tmp = path.with_name(path.name + ".tmp")
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            self.path(old).unlink()

    def restore_any(self, step: int | None = None):
        """(the saved dict, step), or (None, None) when no checkpoint
        exists; tensors load on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True), step

    def restore(self, model, optimizer=None, step: int | None = None):
        """Load a checkpoint into `model` (strictly) and, when given, into
        `optimizer` (a core.optim.Optimizer: the torch optimizer and its
        schedule, `Optimizer.load_state_dict`).  Returns its step, or None
        when there is none."""
        state, step = self.restore_any(step)
        if state is None:
            return None
        model.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state)
        return step


def load_params_partial(model, loaded, logger=None):
    """Shape-tolerant partial load (model_utils.py:8-43): copy the entries
    of the state_dict `loaded` whose name and shape match `model`'s; keep
    the model's own elsewhere.  Returns the number of entries copied."""
    own = model.state_dict()
    hit = {k: v for k, v in loaded.items()
           if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(hit, strict=False)
    if logger:
        logger.info(f"partial load: matched {len(hit)}/{len(own)} tensors")
    return len(hit)

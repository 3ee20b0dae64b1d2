"""The trainer (single-device port of detzero_tpu/parallel/trainer.Trainer):
the training step (loss, backward, gradient global norm and clip, optimizer
and schedule step; the model updates its BN running statistics in the
forward) and `fit`, the reference's loop around it (train_utils.py:94
train_model): batches prefetched by a host thread onto the device,
metrics.jsonl and optional TensorBoard scalars, checkpoint rotation and
auto-resume (core/checkpoint), and a torch.profiler trace of a step range.
Data parallelism is not ported yet (ROADMAP queue 1)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from detzero_tpu_torch.core.checkpoint import CheckpointManager
from detzero_tpu_torch.core.optim import Optimizer


class Trainer:
    """Owns a model, its `Optimizer` and the step count.
    `model.loss(**batch, generator=g)` returns (loss, aux dict); unless the
    batch names its own, `g` is a torch.Generator on the model's device
    that depends only on (seed, step), so a resumed run draws what an
    unbroken one draws (the second stage's RoI subsample).  `stage_hook`, as
    `CenterPoint.stage_hook`, is called where the backward and the
    optimizer step begin.  With `ckpt_dir`, checkpoints go to that
    directory and metrics to `<ckpt_dir>/metrics.jsonl`."""

    stage_hook = None

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 ckpt_dir=None, logger=None, max_ckpt: int = 5,
                 log_every: int = 50, tb_dir=None, steps_per_call: int = 1,
                 prefetch: int = 2, seed: int = 0):
        if int(steps_per_call) != 1:
            # the reference scans several steps in one jit call; the
            # port's counterpart is capturing steps in CUDA graphs
            raise NotImplementedError(
                "steps_per_call > 1 is not ported: several steps a call "
                "wait for CUDA graphs (ROADMAP queue 2 item 1)")
        self.model = model
        self.optimizer = optimizer
        self.seed = int(seed)
        self.step_count = 0
        self.logger = logger
        self.ckpt = CheckpointManager(ckpt_dir, max_ckpt) if ckpt_dir \
            else None
        self.log_every = int(log_every)
        self.metrics_path = (Path(ckpt_dir) / "metrics.jsonl") if ckpt_dir \
            else None
        # host batch assembly runs in a worker thread `prefetch` batches
        # ahead, so it overlaps the device's work (0 disables)
        self.prefetch = int(prefetch)
        self.tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(str(tb_dir))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def step(self, batch: Mapping[str, Any]):
        """One optimizer step on `batch` (the keyword arguments of
        `model.loss`).  Returns (loss, aux, gnorm) as detached tensors on
        the model's device, gnorm before clipping; nothing waits for the
        device."""
        kwargs = dict(batch)
        kwargs.setdefault("generator", self.step_generator())
        loss, aux = self.model.loss(**kwargs)
        if self.stage_hook is not None:
            self.stage_hook("backward")
        self.optimizer.zero_grad()
        loss.backward()
        if self.stage_hook is not None:
            self.stage_hook("optimizer")
        gnorm = self.optimizer.step()
        self.step_count += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, gnorm

    def step_generator(self) -> torch.Generator:
        """The generator of the step about to run: seeded with
        seed * 1_000_003 + step, `step` the global step count before it
        (the count the reference folds into PRNGKey(seed) with
        jax.random.fold_in), on the model's device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1_000_003 + self.step_count)
        return g

    # ------------------------------------------------------------------
    def state_dict(self):
        return {"model": self.model.state_dict(),
                **self.optimizer.state_dict(), "step": self.step_count}

    def save(self):
        self.ckpt.save(self.step_count, self.state_dict())

    def resume(self):
        """Auto-resume from the latest checkpoint (train.py:141-147).
        Returns its step, or None."""
        if self.ckpt is None:
            return None
        step = self.ckpt.restore(self.model, self.optimizer)
        if step is not None:
            self.step_count = step
            if self.logger:
                self.logger.info(f"resumed from step {step}")
        return step

    def to_device(self, batch):
        """The batch's arrays as tensors on the model's device, through
        pinned host memory when that is a card; non-array entries (frame
        ids, poses as lists) are dropped, since the loss reads arrays
        only."""
        device = self.device
        out = {}
        for k, v in batch.items():
            if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v) >= 1:
                t = torch.as_tensor(v)
                if device.type == "cuda":
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=True)
        return out

    def fit(self, batch_iter, total_steps: int, save_every: int = 1000,
            profile_dir=None, profile_range=(10, 20)):
        """Steps over `batch_iter` (dicts of numpy arrays or tensors) until
        the step count reaches `total_steps`; saves every `save_every`
        steps and at the end.  Returns the step count.
        profile_dir: when set, a torch.profiler trace (Chrome format) of
        the steps in [profile_range) is written there."""
        batches = (self.to_device(b) for b in batch_iter)
        if self.prefetch > 0:
            batches = _prefetch_iter(batches, self.prefetch)
        try:
            self._loop(batches, total_steps, save_every, profile_dir,
                       profile_range)
        finally:
            batches.close()      # stops the prefetch thread
        if self.ckpt and self.ckpt.latest_step() != self.step_count:
            self.save()
        return self.step_count

    def _loop(self, batches, total_steps, save_every, profile_dir,
              profile_range):
        t0 = time.time()
        window = []
        prof = None
        for batch in batches:
            if self.step_count >= total_steps:
                break
            if profile_dir and prof is None and \
                    profile_range[0] <= self.step_count < profile_range[1]:
                prof = _start_profiler()
            loss, aux, gnorm = self.step(batch)
            step = self.step_count
            if prof is not None and step >= profile_range[1]:
                prof = _stop_profiler(prof, profile_dir, self.logger)
            window.append(loss)
            if step % self.log_every == 0:
                # the loop's only wait for the device, besides the saves
                mean = float(np.mean(torch.stack(window).float().cpu()
                                     .numpy(), dtype=np.float64))
                dt = (time.time() - t0) / max(len(window), 1)
                msg = (f"step {step}/{total_steps} loss {mean:.4f} "
                       f"gnorm {float(gnorm):.2f} {dt*1000:.0f} ms/it")
                if self.logger:
                    self.logger.info(msg)
                self._log_metrics(step, {
                    "loss": mean, "gnorm": float(gnorm),
                    "ms_per_it": dt * 1000,
                    **{k: float(v.float().mean()) for k, v in aux.items()}})
                window, t0 = [], time.time()
            if self.ckpt and step % save_every == 0:
                self.save()
            if step >= total_steps:
                break
        if prof is not None:
            _stop_profiler(prof, profile_dir, self.logger)

    def _log_metrics(self, step, scalars):
        if self.metrics_path:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps({"step": step, **scalars}) + "\n")
        if self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir, logger):
    """Stops `prof` and writes its Chrome trace into profile_dir; returns
    None (no profiler running)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    path = Path(profile_dir) / f"trace_{int(time.time())}.json"
    prof.export_chrome_trace(str(path))
    if logger:
        logger.info(f"profiler trace written to {path}")
    return None


def _prefetch_iter(it, depth: int):
    """Run the generator `it` in a worker thread, `depth` items ahead:
    overlaps host batch assembly and the copy to the device with the
    device's compute.  Closing this generator stops the worker, closes
    `it` and joins the thread."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        exc = None
        try:
            for item in it:
                if not put(("item", item)):
                    break
        except BaseException as e:  # propagate into the consumer
            exc = e
        finally:
            it.close()
        put(("end", exc))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "end":
                if payload is not None:
                    raise payload
                return
            yield payload
    finally:
        stop.set()
        thread.join()

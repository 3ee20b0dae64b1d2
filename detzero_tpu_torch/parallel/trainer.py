"""The trainer (port of detzero_tpu/parallel/trainer.Trainer): the
training step (loss, backward, gradient global norm and clip, optimizer
and schedule step; the model updates its BN running statistics in the
forward), several steps a call (`steps_per_call`, the reference's scan)
and `fit`, the reference's loop around it (train_utils.py:94
train_model): batches prefetched by a host thread onto the device,
metrics.jsonl and optional TensorBoard scalars, checkpoint rotation and
auto-resume (core/checkpoint), and a torch.profiler trace of a step range.

Data parallelism, one process a card (core/mesh.py): each rank steps on
its slice of the global batch; the masked BN's statistics are the global
batch's (models/layers.py), the gradients are averaged over the ranks
before the clip and the optimizer, and rank 0's parameters and buffers
are broadcast at the start and after a resume, so every rank holds the
same state after every step.  Rank 0 alone writes checkpoints, metrics,
TensorBoard and log lines; every rank resumes from the same file, and a
checkpoint resumes with any number of ranks."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from detzero_tpu_torch.core import profiling
from detzero_tpu_torch.core.checkpoint import CheckpointManager
from detzero_tpu_torch.core.mesh import Mesh, barrier, make_mesh, rank_seed
from detzero_tpu_torch.core.optim import Optimizer


def _coalesced(tensors, fn):
    """Runs fn (an in-place collective) once on each dtype's tensors
    packed into one flat buffer, and copies the result back."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        for t, chunk in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(chunk.view_as(t))


class Trainer:
    """Owns a model, its `Optimizer`, the step count and the mesh.
    `model.loss(**batch, generator=g)` returns (loss, aux dict); unless the
    batch names its own, `g` is a torch.Generator on the model's device
    that depends only on (seed, step, rank), so a resumed run draws what an
    unbroken one draws (the second stage's RoI subsample).  `stage_hook`, as
    `CenterPoint.stage_hook`, is called where the backward, the gradient
    all-reduce (under a group) and the optimizer step begin; the active
    `core/profiling` recording gets the same stages under a `step` span a
    call, which carries `step_count`.  With `ckpt_dir`, checkpoints go to
    that directory and metrics to `<ckpt_dir>/metrics.jsonl`.  `mesh` defaults to `make_mesh()`: every
    rank of the process group, or one process without one."""

    stage_hook = None

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 ckpt_dir=None, logger=None, max_ckpt: int = 5,
                 log_every: int = 50, tb_dir=None, steps_per_call: int = 1,
                 prefetch: int = 2, seed: int = 0, mesh: Mesh | None = None):
        if int(steps_per_call) < 1:
            raise ValueError(f"steps_per_call {steps_per_call} < 1")
        self.model = model
        self.optimizer = optimizer
        self.seed = int(seed)
        self.step_count = 0
        self.steps_per_call = int(steps_per_call)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.is_main = self.mesh.rank == 0
        self.logger = logger
        self.ckpt = CheckpointManager(ckpt_dir, max_ckpt) if ckpt_dir \
            else None
        self._saved_step = None
        self.log_every = int(log_every)
        self.metrics_path = (Path(ckpt_dir) / "metrics.jsonl") \
            if ckpt_dir and self.is_main else None
        # host batch assembly runs in a worker thread `prefetch` batches
        # ahead, so it overlaps the device's work (0 disables)
        self.prefetch = int(prefetch)
        self.tb = None
        if tb_dir and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(str(tb_dir))
        self.broadcast_state()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _stage(self, name):
        if self.stage_hook is not None:
            self.stage_hook(name)
        if profiling.ACTIVE is not None:
            profiling.ACTIVE.mark(name)

    # ------------------------------------------------------------------
    def broadcast_state(self):
        """Rank 0's parameters and buffers on every rank (nothing without
        a group)."""
        group = self.mesh.group
        if group is None:
            return
        with torch.no_grad():
            _coalesced(list(self.model.parameters())
                       + list(self.model.buffers()),
                       lambda flat: dist.broadcast(flat, 0, group=group))

    def average_gradients(self):
        """Every parameter's gradient averaged over the ranks, in one
        all-reduce a dtype (a missing gradient counts as zero, as optax
        updates every leaf)."""
        params = self.optimizer.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        group, world = self.mesh.group, self.mesh.world

        def mean(flat):
            dist.all_reduce(flat, group=group)
            flat.div_(world)

        with torch.no_grad():
            _coalesced([p.grad for p in params], mean)

    def step(self, batch: Mapping[str, Any]):
        """One optimizer step on `batch` (the keyword arguments of
        `model.loss`; under a group, this rank's slice of the global
        batch).  Returns (loss, aux, gnorm) as detached tensors on the
        model's device: this rank's loss and aux, the global gradient's
        norm before clipping; nothing waits for the device."""
        with profiling.span("step", "step_count", self.step_count):
            kwargs = dict(batch)
            kwargs.setdefault("generator", self.step_generator())
            loss, aux = self.model.loss(**kwargs)
            self._stage("backward")
            self.optimizer.zero_grad()
            loss.backward()
            if self.mesh.group is not None:
                self._stage("gradient all-reduce")
                self.average_gradients()
            self._stage("optimizer")
            gnorm = self.optimizer.step()
            self.step_count += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, gnorm

    def steps(self, batches):
        """One `step` a batch of `batches`, in order; returns the means of
        their losses, of each aux term and of their gradient norms, as the
        reference's scan of steps_per_call steps does."""
        out = [self.step(b) for b in batches]
        aux = {k: torch.stack([a[k] for _, a, _ in out]).mean()
               for k in out[0][1]}
        return (torch.stack([o[0] for o in out]).mean(), aux,
                torch.stack([o[2] for o in out]).mean())

    def step_generator(self) -> torch.Generator:
        """The generator of the step about to run: seeded with
        seed * 1_000_003 + step, `step` the global step count before it
        (the count the reference folds into PRNGKey(seed) with
        jax.random.fold_in), on the model's device; rank r > 0 adds
        r * mesh.RANK_SEED_STRIDE, so the ranks draw apart."""
        g = torch.Generator(device=self.device)
        g.manual_seed(rank_seed(self.seed * 1_000_003 + self.step_count,
                                self.mesh.rank))
        return g

    # ------------------------------------------------------------------
    def state_dict(self):
        return {"model": self.model.state_dict(),
                **self.optimizer.state_dict(), "step": self.step_count}

    def save(self):
        """Rank 0 writes the checkpoint of the current step; every rank
        then waits at a barrier, so none reads a directory mid-save."""
        if self.is_main:
            self.ckpt.save(self.step_count, self.state_dict())
        barrier(self.mesh)
        self._saved_step = self.step_count

    def resume(self):
        """Auto-resume from the latest checkpoint (train.py:141-147), the
        same file on every rank, then rank 0's state broadcast.  Returns
        its step, or None."""
        if self.ckpt is None:
            return None
        step = self.ckpt.restore(self.model, self.optimizer)
        if step is not None:
            self.step_count = step
            self._saved_step = step
            self.broadcast_state()
            if self.logger:
                self.logger.info(f"resumed from step {step}")
        return step

    def replica_mismatch(self):
        """The names of the parameters, buffers and optimizer state
        tensors that differ from rank 0's, bit for bit ([] without a
        group); every rank gets the same list.  One broadcast of all of
        them, packed as bytes."""
        group = self.mesh.group
        if group is None:
            return []
        named = list(self.model.state_dict(keep_vars=True).items())
        for i, p in enumerate(self.optimizer.params):
            for k, v in self.optimizer.optimizer.state.get(p, {}).items():
                if isinstance(v, torch.Tensor):
                    named.append((f"optimizer.{i}.{k}", v))
        named.append(("step", torch.tensor([self.step_count],
                                           device=self.device)))
        with torch.no_grad():
            mine = torch.cat([t.detach().reshape(-1).contiguous()
                              .view(torch.uint8) for _, t in named])
            ref = mine.clone()
            dist.broadcast(ref, 0, group=group)
            sizes = [t.numel() * t.element_size() for _, t in named]
            bad = torch.stack([d.any() for d in (ref != mine).split(sizes)]
                              ).to(torch.int32)
            dist.all_reduce(bad, group=group)
        return [n for (n, _), b in zip(named, bad.tolist()) if b]

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
        """Steps over `batch_iter` (dicts of numpy arrays or tensors; under
        a group, this rank's slices) until the step count reaches
        `total_steps`, `steps_per_call` batches a call (a trailing partial
        group is dropped, as the reference's `_stacked` drops it); logs
        when a call crosses a multiple of `log_every`, saves when it
        crosses one of `save_every`, and saves at the end.  Returns the
        step count.  profile_dir: when set, a torch.profiler trace (Chrome
        format) of the steps in [profile_range) is written there (one
        file a rank)."""
        batches = (self.to_device(b) for b in batch_iter)
        if self.prefetch > 0:
            batches = _prefetch_iter(batches, self.prefetch)
        try:
            calls = batches if self.steps_per_call == 1 else \
                _grouped(batches, self.steps_per_call)
            self._loop(calls, total_steps, save_every, profile_dir,
                       profile_range)
        finally:
            batches.close()      # stops the prefetch thread
        if self.ckpt and self._saved_step != self.step_count:
            self.save()
        return self.step_count

    def _loop(self, calls, total_steps, save_every, profile_dir,
              profile_range):
        t0 = time.time()
        window = []
        prof = None
        k = self.steps_per_call
        for call in calls:
            if self.step_count >= total_steps:
                break
            if profile_dir and prof is None and \
                    profile_range[0] <= self.step_count < profile_range[1]:
                prof = profiling.start_capture()
            loss, aux, gnorm = self.step(call) if k == 1 else \
                self.steps(call)
            step = self.step_count
            if prof is not None and step >= profile_range[1]:
                prof = _stop_profiler(prof, profile_dir, self.logger,
                                      self.mesh)
            window.append(loss)
            if step % self.log_every < k:
                self._log(step, total_steps, window, aux, gnorm,
                          (time.time() - t0) / max(len(window), 1))
                window, t0 = [], time.time()
            if self.ckpt and step % save_every < k:
                self.save()
            if step >= total_steps:
                break
        if prof is not None:
            _stop_profiler(prof, profile_dir, self.logger, self.mesh)

    def _log(self, step, total_steps, window, aux, gnorm, dt):
        """The loop's only wait for the device, besides the saves: the
        window's losses and the aux means, averaged over the ranks in one
        all-reduce (the global batch's, as the reference logs them; the
        gradient norm is the global gradient's already)."""
        stats = torch.stack([w.float() for w in window]
                            + [v.float().mean() for v in aux.values()])
        if self.mesh.group is not None:
            dist.all_reduce(stats, group=self.mesh.group)
            stats = stats / self.mesh.world
        stats = stats.cpu().numpy()
        n = len(window)
        mean = float(np.mean(stats[:n], dtype=np.float64))
        if not self.is_main:
            return
        msg = (f"step {step}/{total_steps} loss {mean:.4f} "
               f"gnorm {float(gnorm):.2f} {dt*1000:.0f} ms/it")
        if self.logger:
            self.logger.info(msg)
        self._log_metrics(step, {
            "loss": mean, "gnorm": float(gnorm), "ms_per_it": dt * 1000,
            **{k: float(v) for k, v in zip(aux, stats[n:])}})

    def _log_metrics(self, step, scalars):
        if self.metrics_path:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps({"step": step, **scalars}) + "\n")
        if self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)


def _stop_profiler(prof, profile_dir, logger, mesh):
    """Stops `prof` and writes its Chrome trace into profile_dir (under a
    group, a file a rank); returns None (no profiler running)."""
    profiling.stop_capture(prof)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    rank = f"r{mesh.rank}_" if mesh.group is not None else ""
    path = Path(profile_dir) / f"trace_{rank}{int(time.time())}.json"
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


def _grouped(it, k: int):
    """Lists of k consecutive items of `it`; a trailing shorter list is
    dropped."""
    buf = []
    for item in it:
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []


def eval_gather(results: list) -> list:
    """Every rank's list `results`, concatenated in rank order
    (all_gather_object); `results` itself without a group (the
    reference's process_allgather of per-host results)."""
    group = make_mesh().group
    if group is None:
        return results
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, results, group=group)
    return [x for part in out for x in part]

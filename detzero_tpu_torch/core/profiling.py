"""Tracing and stage timing (port of detzero_tpu/core/profiling.py).

  * :class:`StageTimer` — named wall-clock accumulators with a tabulated
    report, in the reference's format; `pipeline/offboard.py` reports its
    stages with it.  ``timer.block`` also synchronises the card of the
    tensors in a value, so that card work is charged to the stage that
    queued it (the card runs behind the host otherwise).
  * :func:`trace` — context manager around ``torch.profiler.profile``
    (CPU, and CUDA where there is a card) that writes a Chrome trace,
    ``<logdir>/trace.json``; a no-op when given a falsy logdir, so call
    sites can pass the CLI flag straight in.
  * :func:`annotate` — ``torch.profiler.record_function``: a named region
    inside a capture.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from pathlib import Path

import torch


def _cuda_devices(value, out):
    """The CUDA devices of the tensors in a nest of lists, tuples and
    dicts."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> t = StageTimer()
    >>> with t("tracking"):
    ...     run_tracker()
    >>> out = t.block("detection", model.predict(batch))  # waits + charges
    >>> print(t.report())
    """

    def __init__(self):
        self.totals = OrderedDict()
        self.counts = OrderedDict()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def block(self, name: str, value):
        """Wait for the card work behind the tensors in `value` and charge
        the wait to `name`; returns value."""
        with self(name):
            for device in _cuda_devices(value, set()):
                torch.cuda.synchronize(device)
        return value

    def add(self, name: str, seconds: float):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        if not self.totals:
            return "(no stages timed)"
        total = sum(self.totals.values())
        w = max(len(k) for k in self.totals)
        lines = [f"{'stage':<{w}}  {'total_s':>9}  {'calls':>6}  "
                 f"{'mean_ms':>9}  {'share':>6}"]
        for k, v in self.totals.items():
            n = self.counts[k]
            lines.append(f"{k:<{w}}  {v:9.3f}  {n:6d}  "
                         f"{1e3 * v / max(n, 1):9.2f}  "
                         f"{100 * v / max(total, 1e-9):5.1f}%")
        return "\n".join(lines)

    def as_dict(self):
        return {k: {"total_s": self.totals[k], "calls": self.counts[k]}
                for k in self.totals}


@contextlib.contextmanager
def trace(logdir):
    """``torch.profiler`` capture written to ``<logdir>/trace.json``
    (Chrome trace format); no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def annotate(name: str, **kwargs):
    """A named region inside an active trace; keyword arguments (the
    reference's ``step_num=``) are appended to the name."""
    from torch.profiler import record_function

    if kwargs:
        name = name + " " + " ".join(f"{k}={v}" for k, v in kwargs.items())
    return record_function(name)

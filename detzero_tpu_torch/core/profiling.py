"""The program's one recorder of spans, its stage timer and its traces
(port of detzero_tpu/core/profiling.py, grown into the port's tracing).

  * Spans: :func:`span` opens a named region (a context manager) and
    :meth:`Recording.mark` a stage, a child of the innermost open span that
    ends at the next mark or at its parent's end (`CenterPoint._stage` and
    `Trainer._stage` mark their stages here as well as on `stage_hook`).
    Each span has its name, its parent, the call it belongs to (the index
    of its outermost span: every span of one `predict` or `step` call shares
    it) and a host start and end in ns.  Spans are kept only inside
    :func:`recording`, which yields them, and while a capture started here
    (:func:`trace`, :func:`start_capture`) runs, which shows each span as a
    `torch.profiler.record_function` region.  Otherwise `ACTIVE` is None
    and a span or mark costs that one test: no clock read, no Span (the
    `with` statement's own lookups aside).  Spans are recorded from one
    thread.
  * The trace's clock: a recording made while a profiler captures takes
    clock probes at its start and end (a CUDA event recorded, or a
    record_function region on the CPU); :func:`align` finds them in the
    trace and moves the spans onto the trace's clock by the offset they
    measure, so a kernel's launch record can be placed in the span that
    launched it.
  * :class:`StageTimer`: named wall-clock totals with a tabulated report in
    the reference's format, each stage a span; `pipeline/offboard.py`
    reports its stages with it.  ``timer.block`` also synchronises the card
    of the tensors in a value, so that card work is charged to the stage
    that queued it (the card runs behind the host otherwise).
  * :func:`trace`: a ``torch.profiler`` capture (CPU, and CUDA where there
    is a card) written as a Chrome trace, ``<logdir>/trace.json``; a no-op
    when given a falsy logdir, so call sites can pass the CLI flag in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import OrderedDict
from pathlib import Path

import torch

# the recording that spans and marks go to; None: spans are off
ACTIVE = None
# the host clock of the spans (ns); read only while ACTIVE is set
_clock = time.perf_counter_ns
# clock probes at each end of a recording made under a capture
PROBES = 16
PROBE_REGION = "profiling.clock_probe"
# what a capture restores when it stops: (ACTIVE before it, its annotate)
_captures = []


class Span:
    """One region of the program.  `parent` and `call` are indices into
    the recording (`call` that of the outermost span); `args` holds the
    span's one argument (a step's `step_count`, a sample's `index`) or
    None; `stage` tells a stage (opened by a mark) from a span."""

    __slots__ = ("name", "index", "parent", "call", "start_ns", "end_ns",
                 "args", "stage", "_rec", "_region")

    def __init__(self, rec, name, index, parent, call, args, stage):
        self._rec, self.name, self.index = rec, name, index
        self.parent, self.call, self.args, self.stage = (parent, call, args,
                                                         stage)
        self.start_ns = self.end_ns = None
        self._region = None

    @property
    def duration_ns(self):
        return self.end_ns - self.start_ns

    @property
    def label(self):
        """The name, with its argument as `key=value`."""
        if not self.args:
            return self.name
        return self.name + " " + " ".join(f"{k}={v}"
                                          for k, v in self.args.items())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._rec.close(self)
        return False

    def __repr__(self):
        return (f"Span({self.label!r}, parent={self.parent}, "
                f"call={self.call}, {self.start_ns}..{self.end_ns})")


class Recording(list):
    """The spans of one recording, in the order they opened.  `probes`
    holds the (before, after) host ns of each clock probe, `clock` says
    whose clock the times are on ("host", or "trace" after `align`)."""

    def __init__(self, annotate=False):
        super().__init__()
        self.annotate = annotate
        self.stack = []
        self.probes = []
        self.probe_record = None
        self.clock = "host"

    def open(self, name, key=None, value=None, stage=False, now=None):
        parent = self.stack[-1] if self.stack else None
        s = Span(self, name, len(self),
                 None if parent is None else parent.index,
                 len(self) if parent is None else parent.call,
                 None if key is None else {key: value}, stage)
        if self.annotate:
            from torch.profiler import record_function

            s._region = record_function(s.label)
            s._region.__enter__()
        s.start_ns = _clock() if now is None else now
        self.append(s)
        self.stack.append(s)
        return s

    def close(self, s, now=None):
        """Ends `s` and the stages still open inside it."""
        if s.end_ns is not None:
            return
        now = _clock() if now is None else now
        while self.stack:
            top = self.stack.pop()
            top.end_ns = now
            if top._region is not None:
                top._region.__exit__(None, None, None)
                top._region = None
            if top is s:
                return

    def mark(self, name):
        """Ends the open stage of the innermost span, if any, and opens
        stage `name` under it at the same instant."""
        now = _clock()
        if self.stack and self.stack[-1].stage:
            self.close(self.stack[-1], now)
        self.open(name, stage=True, now=now)

    def finish(self):
        if self.stack:
            self.close(self.stack[0])

    def self_ns(self):
        """Each span's time less its children's, in ns."""
        out = [s.duration_ns for s in self]
        for s in self:
            if s.parent is not None:
                out[s.parent] -= s.duration_ns
        return out

    def innermost(self, t_ns):
        """The innermost span with start <= t_ns < end, or None."""
        j = bisect.bisect_right([s.start_ns for s in self], t_ns) - 1
        while j is not None and j >= 0:
            if t_ns < self[j].end_ns:
                return self[j]
            j = self[j].parent
        return None


_OFF = contextlib.nullcontext()


def span(name, key=None, value=None):
    """A region `name` of the active recording, with one optional argument
    `key`=`value` (no keyword dict, so an off span allocates nothing);
    use as ``with span("predict"):``.  A shared no-op while spans are
    off."""
    rec = ACTIVE
    if rec is None:
        return _OFF
    return rec.open(name, key, value)


def _under_capture():
    from torch.autograd import profiler

    return bool(getattr(profiler, "_is_profiler_enabled", False))


def _probe(rec):
    """PROBES clock probes: each a record in the trace between two host
    stamps."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        ev = torch.cuda.Event()     # created at its first record
        # torch records with cudaEventRecordWithFlags, older torch with
        # cudaEventRecord: the record's name starts with this
        rec.probe_record = "cudaEventRecord"
        for _ in range(PROBES):
            a = _clock()
            ev.record()
            rec.probes.append((a, _clock()))
        return
    from torch.profiler import record_function

    rec.probe_record = PROBE_REGION
    for _ in range(PROBES):
        a = _clock()
        with record_function(PROBE_REGION):
            pass
        rec.probes.append((a, _clock()))


@contextlib.contextmanager
def recording():
    """Records the program's spans; yields the Recording, whose spans are
    complete when the block ends.  Under a running profiler it probes the
    clock at both ends, for :func:`align`."""
    global ACTIVE
    outer = ACTIVE
    rec = Recording(annotate=outer is not None and outer.annotate)
    probing = _under_capture()
    if probing:
        _probe(rec)
    ACTIVE = rec
    try:
        yield rec
    finally:
        ACTIVE = outer
        rec.finish()
        if probing:
            _probe(rec)


def host_records(prof):
    """(name, start ns) of the host-side records of a finished
    torch.profiler capture, on the trace's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            out.append((e.name(), e.start_ns()))
    return out


def align(rec, records):
    """Moves a recording's spans onto the trace's clock.  `records` are
    the trace's host records ((name, start ns), `host_records`); the
    first and last PROBES records whose names start with the probe's are
    the recording's probes at its start and end.  Each probe gives the
    offset of the host clock from the trace's (its stamps' midpoint less
    its record); the offset is taken as linear in time between the two
    ends.  Returns the fit: offset_ns at the start, drift_ns to the end,
    the largest distance of a probe's record from its stamps' window
    (spread_ns, 0 when every record lies inside its window) and the
    windows' median width (window_ns)."""
    if rec.clock != "host":
        raise ValueError("the recording is on the trace's clock already")
    k = PROBES
    if len(rec.probes) != 2 * k:
        raise ValueError(f"the recording holds {len(rec.probes)} clock "
                         f"probes, not {2 * k}: record under a running "
                         f"profiler")
    got = sorted(t for name, t in records
                 if name.startswith(rec.probe_record))
    if len(got) < 2 * k:
        raise ValueError(f"the trace holds {len(got)} {rec.probe_record} "
                         f"records; the recording's {2 * k} probes need "
                         f"as many")
    pairs = list(zip(rec.probes, got[:k] + got[-k:]))

    def median_offset(part):
        offs = sorted((a + b) // 2 - r for (a, b), r in part)
        return offs[len(offs) // 2], part[len(part) // 2][0][0]

    (o0, t0), (o1, t1) = median_offset(pairs[:k]), median_offset(pairs[k:])
    slope = (o1 - o0) / (t1 - t0) if t1 > t0 else 0.0

    def to_trace(t):
        return t - o0 - int(round(slope * (t - t0)))

    spread = 0
    for (a, b), r in pairs:
        spread = max(spread, to_trace(a) - r, r - to_trace(b))
    for s in rec:
        s.start_ns, s.end_ns = to_trace(s.start_ns), to_trace(s.end_ns)
    rec.clock = "trace"
    return {"offset_ns": o0, "drift_ns": o1 - o0, "spread_ns": spread,
            "window_ns": sorted(b - a for (a, b), _ in pairs)[k]}


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
    """Accumulates wall-clock per named stage; each stage is a span of the
    active recording (of a recording of its own when none is active).

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
        rec = ACTIVE if ACTIVE is not None else Recording()
        s = rec.open(name)
        try:
            yield self
        finally:
            rec.close(s)
            self.add(name, s.duration_ns / 1e9)

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


def start_capture():
    """Starts a ``torch.profiler`` capture (CPU, and CUDA where there is a
    card) in which the program's spans are record_function regions, until
    :func:`stop_capture`.  Returns the profiler."""
    global ACTIVE
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _captures.append((ACTIVE, ACTIVE is not None and ACTIVE.annotate))
    if ACTIVE is None:
        ACTIVE = Recording(annotate=True)
    ACTIVE.annotate = True
    return prof


def stop_capture(prof):
    """Stops a capture of :func:`start_capture` (the card synchronised
    first) and the spans' regions."""
    global ACTIVE
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    outer, annotate = _captures.pop()
    if outer is None:
        ACTIVE.finish()
    else:
        outer.annotate = annotate
    ACTIVE = outer
    prof.stop()


@contextlib.contextmanager
def trace(logdir):
    """A capture of :func:`start_capture` written to
    ``<logdir>/trace.json`` (Chrome trace format); no-op when logdir is
    falsy."""
    if not logdir:
        yield
        return
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    prof = start_capture()
    try:
        yield prof
    finally:
        stop_capture(prof)
    prof.export_chrome_trace(str(logdir / "trace.json"))

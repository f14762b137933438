"""Profiling and timing helpers.

Counterpart of the JAX package's ``utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (``chrome://tracing``, Perfetto) of everything run inside it, and the
  totals of the program's spans and counters beside it;
* :func:`span`, :func:`count`, :func:`totals`, :func:`reset` and
  :func:`enabled`: the program's spans and counters, which record while a
  ``torch.profiler`` session records and cost one flag read otherwise;
* :func:`timed`: steady-state seconds per call, ``(t(r2) - t(r1)) / (r2 -
  r1)`` over two repetition counts, which cancels the fixed cost of a
  measurement (launch queue, synchronisation): CUDA events on the card,
  the host clock on the CPU.

A span names a stretch of the program (``train.step``, ``render.project``,
``sync.metrics``, ...).  While a profiler session records, a span enters
``torch.profiler.record_function`` under its name, so it sits in the
profiler's trace on the device trace's clock, and it keeps its host time,
its self host time (less its child spans'), and on the card the time
between two CUDA events it records on the current stream: its stretch of
the device timeline, idle time inside it included.  Every ``sync.*`` span
wraps one blocking device-to-host read and adds 1 to the counter
``host_syncs``.  A counter sums host numbers or 0-d device tensors; a
device value stays on the device until :func:`totals` reads it.  Nothing
here synchronises the device while it records: a span's events are read
once a ``sync.*`` span's read has drained the stream, or at
:func:`totals`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

_autograd_profiler = torch.autograd.profiler
# Folding waits for this many open event pairs before it reads the
# finished ones without a sync span's help (a render loop has none).
_PENDING_FOLD = 1024


def enabled() -> bool:
    """True while a ``torch.profiler`` session records: spans and counters
    record exactly then."""
    return _autograd_profiler._is_profiler_enabled


class _Log:
    """What the spans and counters recorded since the last :meth:`reset`."""

    def __init__(self):
        self.local = threading.local()   # each thread's stack of open spans
        self.pool: List[torch.cuda.Event] = []
        self.reset()

    def reset(self) -> None:
        self.spans: Dict[str, dict] = {}
        self.pending: List[Tuple[str, object, object]] = []
        self.host_counts: Dict[str, float] = defaultdict(float)
        self.device_counts: Dict[str, torch.Tensor] = {}

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event(self):
        """A timing CUDA event recorded on the current stream, or None
        where the process uses no card."""
        if not torch.cuda.is_initialized():
            return None
        ev = self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)
        ev.record()
        return ev

    def close(self, name: str, parent: Optional[str], host_ns: int,
              self_ns: int, ev0, ev1) -> None:
        s = self.spans.get(name)
        if s is None:
            s = self.spans[name] = {"count": 0, "host_s": 0.0,
                                    "self_host_s": 0.0, "card_s": None,
                                    "parents": []}
        s["count"] += 1
        s["host_s"] += host_ns / 1e9
        s["self_host_s"] += self_ns / 1e9
        if parent not in s["parents"]:
            s["parents"].append(parent)
        if ev0 is not None and ev1 is not None:
            self.pending.append((name, ev0, ev1))
            if len(self.pending) >= _PENDING_FOLD:
                self.fold()

    def fold(self, wait: bool = False) -> None:
        """Add the card time of every span whose end event has passed
        (all of them, waiting, with ``wait``) and recycle its events."""
        keep = []
        for name, ev0, ev1 in self.pending:
            if wait:
                ev1.synchronize()
            elif not ev1.query():
                keep.append((name, ev0, ev1))
                continue
            s = self.spans[name]
            s["card_s"] = (s["card_s"] or 0.0) + ev0.elapsed_time(ev1) / 1e3
            self.pool += (ev0, ev1)
        self.pending = keep

    def add(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor) and value.device.type != "cpu":
            acc = self.device_counts.get(name)
            if acc is None:
                acc = self.device_counts[name] = torch.zeros(
                    (), dtype=torch.float64, device=value.device)
            acc.add_(value.detach().reshape(()))
        else:
            self.host_counts[name] += float(value)

    def totals(self) -> dict:
        self.fold(wait=True)
        counters = dict(self.host_counts)
        for name, acc in self.device_counts.items():
            counters[name] = counters.get(name, 0.0) + acc.item()
        return {"spans": {k: dict(v, parents=list(v["parents"]))
                          for k, v in self.spans.items()},
                "counters": counters}


_LOG = _Log()


class _Span:
    """An open span while recording (see :func:`span`)."""

    __slots__ = ("name", "args", "parent", "child_ns", "rf", "ev0", "t0")

    def __init__(self, name: str, args: Optional[str]):
        self.name, self.args = name, args

    def __enter__(self):
        # The range opens first and closes last, so that the bookkeeping
        # sits inside it on the profiler's timeline.
        self.rf = _autograd_profiler.record_function(self.name, self.args)
        self.rf.__enter__()
        st = _LOG.stack()
        self.parent = st[-1] if st else None
        st.append(self)
        self.child_ns = 0
        if self.name.startswith("sync."):
            _LOG.add("host_syncs", 1)
        self.ev0 = _LOG.event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        ev1 = _LOG.event()
        _LOG.stack().pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        _LOG.close(self.name, None if parent is None else parent.name, dur,
                   dur - self.child_ns, self.ev0, ev1)
        if self.name.startswith("sync."):
            # The read has drained the stream up to here.
            _LOG.fold()
        self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **args):
    """A context manager that records the block as the span ``name``
    while a profiler session records (``args``, such as the trainer's
    step, go with it into the trace); a shared no-op otherwise, and
    inside a span of the same name that is open on this thread, which
    already counts the block."""
    if not enabled() or any(s.name == name for s in _LOG.stack()):
        return _OFF
    return _Span(name, ",".join(f"{k}={v}" for k, v in args.items())
                 if args else None)


def count(name: str, value) -> None:
    """Add ``value`` (a number, a 0-d tensor, or a callable that returns
    one, called only while recording) to the counter ``name`` while a
    profiler session records; nothing otherwise."""
    if not enabled():
        return
    _LOG.add(name, value() if callable(value) else value)


def totals() -> dict:
    """What was recorded since the last :func:`reset`: ``{"spans": {name:
    {"count", "host_s", "self_host_s", "card_s" (None off the card),
    "parents"}}, "counters": {name: sum}}``.  Waits for the device work
    that the recorded spans and counters cover."""
    return _LOG.totals()


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _LOG.reset()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Profile the block (host, and the card when there is one) and write
    ``logdir/trace.json`` as a Chrome trace and ``logdir/totals.json``, the
    block's :func:`totals`.  Yields the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    with open(os.path.join(logdir, "totals.json"), "w") as f:
        json.dump(totals(), f, indent=1)


def _run_seconds(fn: Callable, args, reps: int, cuda: bool) -> float:
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return time.perf_counter() - t0


def timed(fn: Callable, *args, reps: Tuple[int, int] = (2, 10)) -> float:
    """Steady-state seconds per call of ``fn(*args)``: one warm-up call,
    then ``r1`` and ``r2`` calls back to back, and ``(t(r2) - t(r1)) / (r2
    - r1)`` (never below 0).  CUDA events time the card's stream when a
    card is present; the host clock times the CPU otherwise."""
    cuda = torch.cuda.is_available()
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    r1, r2 = reps
    t_a = _run_seconds(fn, args, r1, cuda)
    t_b = _run_seconds(fn, args, r2, cuda)
    return max(t_b - t_a, 0.0) / (r2 - r1)

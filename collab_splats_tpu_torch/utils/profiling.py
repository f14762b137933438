"""Profiling and timing helpers.

Counterpart of the JAX package's ``utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (``chrome://tracing``, Perfetto) of everything run inside it;
* :func:`timed`: steady-state seconds per call, ``(t(r2) - t(r1)) / (r2 -
  r1)`` over two repetition counts, which cancels the fixed cost of a
  measurement (launch queue, synchronisation): CUDA events on the card,
  the host clock on the CPU;
* :func:`device_breakdown` and :func:`say_breakdown`: the card time of a
  call by ATen op, and the card's idle share of the host time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, List, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Profile the block (host, and the card when there is one) and write
    ``logdir/trace.json`` as a Chrome trace.  Yields the file's path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


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


def device_breakdown(fn: Callable, reps: int = 3, top: int = 8
                     ) -> Tuple[float, float, List[Tuple[str, float, float]]]:
    """A ``torch.profiler`` trace of ``reps`` calls of ``fn`` after one
    untraced call.  Returns (host ms per call, card ms per call: the sum of
    the kernels' durations, [(op and input shapes, self card ms per call,
    calls per call)] of the ``top`` ATen ops by the card time of the
    kernels they launch themselves).  On the CPU the card time is 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def card_us(e):
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    fn()
    sync()
    with profile(activities=activities, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        host = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.key_averages(group_by_input_shape=True)
    card = sum(card_us(e) for e in events
               if e.device_type == DeviceType.CUDA) / 1e3 / reps
    ops = sorted(((f"{e.key}{list(e.input_shapes) if e.input_shapes else ''}",
                   card_us(e) / 1e3 / reps, e.count / reps)
                  for e in events if e.key.startswith("aten::")
                  and card_us(e) > 0), key=lambda r: -r[1])
    return host, card, ops[:top]


def say_breakdown(what: str, breakdown, say: Callable[[str], None] = print
                  ) -> None:
    """One line of a :func:`device_breakdown`: host and card ms per call,
    the card's idle share of the host time, and the top ops."""
    host, card, ops = breakdown
    if card == 0:
        say(f"{what}: torch.profiler saw no card time (host {host:.4f} ms)")
        return
    say(f"{what} (torch.profiler, ms per call): host {host:.4f}, card "
        f"{card:.4f} (idle {1 - card / host:.1%}); ops by their kernels' "
        f"card time: " + "; ".join(f"{k} {t:.4f} x{n:g}" for k, t, n in ops))

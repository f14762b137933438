"""Reduction of a profiler trace to the device's busy time, each kernel's
time and the host's part in the device's idle gaps.

A trace is a list of :class:`Event`: host operations (aten operators,
runtime calls, the harness's own spans) and device operations (kernels,
copies, memsets) on one clock.  The device is busy for the union of its
operations' intervals, so operations that overlap are counted once.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW_SPAN = "bench.window"
PROFILER_OWN = ("Activity Buffer Request",)


class Event(NamedTuple):
    name: str
    on_device: bool
    start_us: float
    end_us: float


def from_profiler(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``.  The copies
    of host annotations that the profiler draws on the device's timeline
    are no device work and are left out, as are the profiler's own
    buffer requests."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != DeviceType.CPU
        if (on_device and e.is_user_annotation()) or \
                e.name() in PROFILER_OWN:
            continue
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), on_device, start,
                         start + e.duration_ns() / 1e3))
    return out


def union_length(intervals: List[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


_ANON = "(anonymous namespace)::"


def symbol(name: str) -> str:
    """A kernel's function name without return type, namespaces,
    template arguments or parameters: ``void (anonymous
    namespace)::composite_kernel<6>(float const*, ...)`` gives
    ``composite_kernel``."""
    s = name.replace(_ANON, "")
    s = s.split("(", 1)[0]
    s = s.split("<", 1)[0].strip()
    s = s.split(" ")[-1]
    return s.split("::")[-1]


class TraceSummary(NamedTuple):
    window_s: float                  # the traced window's length
    busy_s: float                    # device busy, union of its operations
    device_s: Dict[str, float]       # device seconds by full name
    symbol_s: Dict[str, float]       # device seconds by kernel symbol
    idle_by_host: Dict[str, float]   # idle seconds by enclosing host op


def _innermost(host: List[Event], points: List[float]) -> List[str]:
    """For each point, the host operation that started last among those
    running at it (any thread), or "host (no op)"."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    evs = sorted(host, key=lambda e: e.start_us)
    out = ["host (no op)"] * len(points)
    active: list = []
    j = 0
    for i in order:
        p = points[i]
        while j < len(evs) and evs[j].start_us <= p:
            heapq.heappush(active, (-evs[j].start_us, j))
            j += 1
        # The points rise, so an event finished at one is finished at the
        # rest: pop it for good.
        while active and evs[active[0][1]].end_us < p:
            heapq.heappop(active)
        if active:
            out[i] = evs[active[0][1]].name
    return out


def summarize(events: List[Event], window: str = WINDOW_SPAN
              ) -> TraceSummary:
    """Busy and idle time of the device inside the host span ``window``.
    Raises if the span is missing or no device operation ran in it."""
    spans = [e for e in events if not e.on_device and e.name == window]
    if not spans:
        raise ValueError(f"the trace has no {window!r} span")
    lo = min(e.start_us for e in spans)
    hi = max(e.end_us for e in spans)
    dev = [e for e in events if e.on_device
           and e.end_us > lo and e.start_us < hi]
    if not dev:
        raise ValueError("no device operation ran in the traced window")
    iv = [(e.start_us, e.end_us) for e in dev]
    busy = union_length(iv, lo, hi)
    device_s: Dict[str, float] = defaultdict(float)
    symbol_s: Dict[str, float] = defaultdict(float)
    for e in dev:
        d = (min(e.end_us, hi) - max(e.start_us, lo)) / 1e6
        device_s[e.name] += d
        symbol_s[symbol(e.name)] += d
    host = [e for e in events if not e.on_device and e.name != window
            and e.end_us > lo and e.start_us < hi]
    idle = gaps(iv, lo, hi)
    names = _innermost(host, [(s + e) / 2 for s, e in idle])
    idle_by: Dict[str, float] = defaultdict(float)
    for (s, e), n in zip(idle, names):
        idle_by[n] += (e - s) / 1e6
    return TraceSummary((hi - lo) / 1e6, busy / 1e6, dict(device_s),
                        dict(symbol_s), dict(idle_by))


def top(d: Dict[str, float], n: int = 10,
        width: Optional[int] = 200) -> List[list]:
    """The ``n`` largest entries as [name, seconds], names cut to
    ``width`` characters."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[k if width is None else k[:width], v] for k, v in items]


def _clean(name: str) -> str:
    return re.sub(r"\s+", " ", name)


def breakdown(s: TraceSummary) -> dict:
    return {"device_ops": [[_clean(k), v] for k, v in top(s.device_s)],
            "idle_gaps": [[_clean(k), v] for k, v in top(s.idle_by_host)]}

"""Arithmetic of a measured window.

A rate is the window's wall time over all the work completed in it, so a
stall inside the window counts in full; a tail is the percentile of every
request's latency in the window, not a median of chunks.
"""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def ms_per_unit(wall_s: float, units: int) -> float:
    """Milliseconds of window per completed step or request."""
    if units <= 0:
        raise ValueError("the window completed no work")
    return wall_s * 1e3 / units


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by the nearest-rank rule: the
    smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


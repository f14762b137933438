"""The arithmetic of the per-layer readers over the program's spans and
counters per unit of a cell's loop that is not a training step: per
``sam.image`` span (an image segmented), or per call of a span itself.
Each returns None where the run has nothing to read (a program without
the spans, a card time off the card), never 0."""

from __future__ import annotations

from typing import Optional

from benchlib.spans import totals


def _count(t: Optional[dict], span: str) -> int:
    if not t:
        return 0
    return t["spans"].get(span, {}).get("count", 0)


def card_ms_per_unit(layer: dict, kind: str, span: str,
                     unit: str) -> Optional[float]:
    """Milliseconds of the span's stretch of the card's timeline, summed
    over its calls, per call of the span ``unit`` (the span itself: per
    call)."""
    t = totals()
    n = _count(t, unit)
    if layer["kind"] != kind or not n:
        return None
    card = t["spans"].get(span, {}).get("card_s")
    return None if card is None else 1e3 * card / n


def count_per_unit(layer: dict, kind: str, counter: str, unit: str,
                   absent: Optional[float] = None) -> Optional[float]:
    """A counter's sum per call of the span ``unit``; ``absent`` where
    the unit was recorded and the counter never was (0 for a counter that
    every event it counts would have recorded)."""
    t = totals()
    n = _count(t, unit)
    if layer["kind"] != kind or not n:
        return None
    if counter not in t["counters"]:
        return absent
    return t["counters"][counter] / n

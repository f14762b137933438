"""The arithmetic of the per-layer readers over the program's own spans and
counters (``collab_splats_tpu_torch/utils/profiling.py::totals``), which
record while the traced window's profiler session records.  Per step means
over the ``train.step`` spans the window holds.  Each returns None where
the run has nothing to read (an empty log, a program without spans, a card
time off the card), never 0."""

from __future__ import annotations

from typing import Optional

STEP = "train.step"


def totals() -> Optional[dict]:
    """The program's span and counter totals, or None where the program
    records none."""
    try:
        from collab_splats_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "totals", None)
    return read() if read is not None else None


def _steps(t: Optional[dict]) -> int:
    if not t:
        return 0
    return t["spans"].get(STEP, {}).get("count", 0)


def card_ms_per_step(layer: dict, kind: str, span: str) -> Optional[float]:
    """Milliseconds per step of the span's stretch of the card's
    timeline (between its two CUDA events), summed over its calls."""
    t = totals()
    n = _steps(t)
    if layer["kind"] != kind or not n:
        return None
    card = t["spans"].get(span, {}).get("card_s")
    return None if card is None else 1e3 * card / n


def count_per_step(layer: dict, kind: str, counter: str
                   ) -> Optional[float]:
    """A counter's sum per step."""
    t = totals()
    n = _steps(t)
    if layer["kind"] != kind or not n or counter not in t["counters"]:
        return None
    return t["counters"][counter] / n


def ratio(layer: dict, kind: str, num: str, den: str,
          scale: float = 1.0) -> Optional[float]:
    """``scale`` times the sum of counter ``num`` over that of ``den``."""
    t = totals()
    if layer["kind"] != kind or not t:
        return None
    c = t["counters"]
    if num not in c or not c.get(den):
        return None
    return scale * c[num] / c[den]

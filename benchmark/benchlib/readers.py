"""The arithmetic of the per-layer readers in ``metrics/``.  Each reader
file names its metric and calls one of these; each returns None where the
run has nothing to read, never 0."""

from __future__ import annotations

from typing import Optional

from counts import FP32_OPS_PER_S

# The port's hand-written kernels (``csrc/``) as the profiler names them:
# kernel 1, 2, 3, the two of kernel 4, 5 and 6.
HAND_WRITTEN = ("decode_kernel", "composite_kernel", "composite_bwd_kernel",
                "segment_starts_kernel", "segment_sums_kernel",
                "composite_tiles_fwd_kernel", "composite_tiles_bwd_kernel")


def idle_pct(layer: dict, kind: str) -> Optional[float]:
    """The device's idle share of the traced window, in %: one minus the
    union of its kernels', copies' and memsets' intervals over the
    window's length."""
    if layer["kind"] != kind:
        return None
    s = layer["summary"]
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def plain_card_ms(layer: dict, kind: str) -> Optional[float]:
    """Device milliseconds per step or request of every device operation
    whose symbol is none of the hand-written kernels: the plain PyTorch
    layers, their copies and memsets."""
    if layer["kind"] != kind:
        return None
    plain = sum(s for name, s in layer["summary"].symbol_s.items()
                if name not in HAND_WRITTEN)
    return 1e3 * plain / layer["units"]


def mfu(layer: dict, kind: str) -> Optional[float]:
    """The whole step's or request's share of the card's float32 peak,
    in %: the useful operations ``counts/step.py`` counts on the reference
    binning of the traced inputs, over the untraced window's time per
    unit times 67 TFLOP/s."""
    if layer["kind"] != kind or not layer["useful_ops"]:
        return None
    per_unit = layer["useful_ops"] / layer["units"]
    return 100.0 * per_unit / (layer["unit_s"] * FP32_OPS_PER_S)


def roofline(layer: dict, kind: str, symbol: str) -> Optional[float]:
    """A kernel's share of its roofline over the traced units, in %: the
    least time its work needs (``counts/``, on the reference binning of
    each unit's inputs) over its device time in the trace.  None where
    it did not run."""
    t = layer["summary"].symbol_s.get(symbol)
    if layer["kind"] != kind or not t:
        return None
    return 100.0 * layer["bound_s"][symbol] / t

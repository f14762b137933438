"""Kernel 2, ``csrc/batched_fwd.cu``: the window compositor's forward.

The formula of ``chip_smoke.py::composite_bound``, re-sourced: the
window slots and the (pixel, slot) pairs are counted on the benchmark's
reference binning of the render's inputs (``reference/render.py``), not
on the program's window rows.
"""

PIXELS = 256   # a 16x16 tile


def count(tiles: int, k: int, v: int, masked_slots: int,
          live_pairs: int) -> tuple:
    """Bytes: the [T, K, 9 + V] window rows and the mask read once, the
    value, alpha, depth, median and median-slot maps written once.
    Operations: 23 float32 operations of alpha and depth per (pixel,
    masked-in slot) pair, and 11 + 2V more (transmittance, weight, value
    FMAs, median key) per pair whose alpha passes the cutoff."""
    d = 9 + v
    nbytes = 4 * (tiles * k * d + tiles * k + tiles * PIXELS * (v + 4))
    ops = 23 * PIXELS * masked_slots + (11 + 2 * v) * live_pairs
    return nbytes, ops

"""Kernel 3, ``csrc/batched_bwd.cu``: the window compositor's backward.

The formula of ``chip_smoke.py::composite_bwd_bound``, re-sourced: the
window slots and the (pixel, slot) pairs are counted on the benchmark's
reference binning of the step's inputs (``reference/render.py``), not on
the program's window rows.
"""

PIXELS = 256   # a 16x16 tile
PREFIX_BATCH = 64


def count(tiles: int, k: int, v: int, masked_slots: int,
          live_pairs: int) -> tuple:
    """Bytes: the window rows, mask and banked prefix, the four
    cotangents, the median slot and T_total read once, the [T, K, 9 + V]
    gradient rows written once.  Operations: the 23 of alpha and depth
    per (pixel, masked-in slot) pair, and 37 + 4V more per pair whose
    alpha passes the cutoff: transmittance (exp, log1p), r (V FMAs),
    d_alpha, d_tpix and d_sigma, and the 9 + V products and 9 + V adds
    of the per-slot pixel sums."""
    d = 9 + v
    nbytes = 4 * (2 * tiles * k * d + tiles * k
                  + -(-k // PREFIX_BATCH) * tiles * PIXELS
                  + tiles * PIXELS * (v + 5))
    ops = 23 * PIXELS * masked_slots + (37 + 4 * v) * live_pairs
    return nbytes, ops

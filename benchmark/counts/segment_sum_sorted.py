"""Kernel 4, ``csrc/segsum_kernel.cu``: rows summed by sorted id.

The formula of ``chip_smoke.py::segsum_bound``; ``m`` is counted on the
reference binning (the window slots that the gather's backward sums).
"""


def count(m: int, d: int, n: int) -> tuple:
    """Bytes: the [M, d] float32 rows, the int32 sorted ids and the int64
    permutation read once, the [n, d] sums written once.  Operations: one
    add per input element."""
    return 4 * m * d + 12 * m + 4 * n * d, m * d

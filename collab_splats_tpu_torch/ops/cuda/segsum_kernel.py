"""The sorted segment sum: its plain version and the wrapper of its kernel
(``csrc/segsum_kernel.cu``).

Replaces the JAX package's Pallas ``ops/pallas/segsum_kernel.py::
segment_sum_sorted`` (with ``expand_bwd_pallas`` around it).  For CPU
tensors the wrapper runs the plain version (:func:`segment_sum_plain`); for
CUDA tensors it launches the kernel or raises.  ``ops/segsum.py`` sorts the
ids and calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0   # kernel launches since the caller last reset it
# Segments longer than this many rows are summed by a whole block of the
# kernel, not by one group of lanes.
LONG_ROWS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int


def segment_starts_plain(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of the kernel's first launch: int32 [n + 1], entry g
    the number of sorted ids below g (where id g's rows begin; entry n is
    M)."""
    queries = torch.arange(n + 1, dtype=sorted_ids.dtype,
                           device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, queries, side="left",
                              out_int32=True)


def segment_sum_plain(sorted_ids: torch.Tensor, order: torch.Tensor,
                      rows: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of the kernel: the rows in sorted order, reduced per
    run of equal ids (exact sums in sorted order, no prefix differences)."""
    start = segment_starts_plain(sorted_ids, n)
    return torch.segment_reduce(rows[order], "sum",
                                lengths=start[1:] - start[:-1], axis=0)


@functools.cache
def _fn():
    fn = build.load("segsum_kernel").segment_sum_sorted
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    return fn


def segment_sum_sorted(sorted_ids: torch.Tensor, order: torch.Tensor,
                       rows: torch.Tensor, n: int,
                       long_rows: int = LONG_ROWS) -> torch.Tensor:
    """Per-id sums of ``rows`` [M, D] float32 into [n, D].

    ``sorted_ids`` [M] int32 are the row ids in [0, n) sorted ascending and
    ``order`` [M] int64 the sort's permutation (``torch.sort``'s indices):
    out[g] = sum of rows[order[i]] over the i with sorted_ids[i] == g, in
    sorted order; 0 for an id that owns no row.  ``long_rows`` moves only
    the work between the kernel's paths (the result is the same bits).
    """
    dev = rows.device
    if dev.type == "cpu":
        return segment_sum_plain(sorted_ids, order, rows, n)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_sorted: unsupported device {dev}")
    if rows.dim() != 2 or rows.dtype != torch.float32 \
            or not rows.is_contiguous():
        raise ValueError("segment_sum_sorted: rows must be contiguous "
                         "float32 [M, D]")
    m, d = rows.shape
    for name, x, dtype in (("sorted_ids", sorted_ids, torch.int32),
                           ("order", order, torch.int64)):
        if x.shape != (m,) or x.dtype != dtype or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"segment_sum_sorted: {name} must be contiguous "
                             f"{dtype} [{m}] on {dev}")
    # The kernel indexes rows and the merged ids with 32-bit ints, and
    # stages a block's output rows in shared memory (128 of them at D > 16).
    if n < 0 or m + n >= (1 << 31) - 64 or m * d >= (1 << 31) \
            or d > 256:
        raise ValueError(f"segment_sum_sorted: n={n}, m={m}, d={d} out of "
                         "range")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    start = torch.empty(n + 1, dtype=torch.int32, device=dev)
    lanes = 1
    while lanes < min(d, 32):
        lanes *= 2
    with torch.cuda.device(dev):
        rc = _fn()(sorted_ids.data_ptr(), order.data_ptr(), rows.data_ptr(),
                   m, n, d, lanes, long_rows, start.data_ptr(),
                   out.data_ptr(), build.stream_handle(dev))
    build.check(rc, "segment_sum_sorted")
    global launches
    launches += 1
    return out

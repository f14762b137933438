"""Scatter-free gradient reduction for the intersection expansion gather.

Counterpart of the JAX package's ``ops/segsum.py``.  The compositor expands
the per-gaussian table [N, D] into per-window-slot rows [M, D] with one row
gather.  The gather's plain autograd backward would be a [M, D] -> [N, D]
scatter-add, which on the card is a float atomic add: its sums land in
another order on every run.  :func:`expand_rows` keeps the gather and
replaces the backward with a sorted segment sum: a stable sort of the ids,
then exact per-gaussian sums in sorted order (``ops/cuda/segsum_kernel.py``:
the CUDA kernel on the card, its plain version on the CPU).  The same sums
serve the densification statistic (``train/strategy.py::update_state``).
"""

from __future__ import annotations

import torch

from .cuda.segsum_kernel import segment_sum_sorted


def spread_masked(idx: torch.Tensor, mask: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Replace masked-out entries of ``idx`` with a uniform spread over
    [0, n), keeping every index in range without funnelling dead slots onto
    one row.  Callers zero the dead rows' contributions."""
    spread = torch.arange(idx.shape[0], dtype=idx.dtype,
                          device=idx.device) % n
    return torch.where(mask, idx, spread)


def segment_sum(idx: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Per-id sums of ``rows`` [M, D] into [n, D] for int32 ``idx`` [M] in
    [0, n): deterministic, exact, and free of float atomics."""
    sorted_ids, order = torch.sort(idx, stable=True)
    return segment_sum_sorted(sorted_ids, order, rows.contiguous(), n)


class _ExpandRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return segment_sum(idx, ct, ctx.n), None


def expand_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: [N, D] rows gathered at int32 [M] indices, all in
    [0, N), with the sorted-segment-sum backward (see the module doc)."""
    return _ExpandRows.apply(table, idx)

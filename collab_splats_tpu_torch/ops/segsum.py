"""The intersection expansion gather (forward only).

Counterpart of the JAX package's ``ops/segsum.py``.  The compositor expands
the per-gaussian table [N, D] into per-window-slot rows [M, D] with one row
gather; this slice needs only that forward.  The sorted-segment-sum
backward comes with the training slice.
"""

from __future__ import annotations

import torch


def spread_masked(idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """Replace masked-out entries of ``idx`` with a uniform spread over
    [0, n), keeping every index in range without funnelling dead slots onto
    one row.  Callers zero the dead rows' contributions."""
    spread = torch.arange(idx.shape[0], dtype=idx.dtype,
                          device=idx.device) % n
    return torch.where(mask, idx, spread)


def expand_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: [N, D] rows gathered at [M] indices, all in [0, N)."""
    return table[idx.long()]

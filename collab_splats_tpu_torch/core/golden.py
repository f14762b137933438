"""Rendered-map container shared by the port's renderers.

Counterpart of ``RenderOutput`` in the JAX package's ``core/golden.py``.
The naive golden renderer itself is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOutput(NamedTuple):
    """Rendered maps, mirroring the reference's rasterization 6-tuple."""

    color: torch.Tensor         # [H, W, C]
    alpha: torch.Tensor         # [H, W]
    depth: torch.Tensor         # [H, W] expected depth
    median_depth: torch.Tensor  # [H, W]
    normal: torch.Tensor        # [H, W, 3] camera-space
    spilled: torch.Tensor       # [] int32: splats dropped by capacity limits

"""Gaussian parameter dict: activation, capacity padding, loading.

Counterpart of the JAX package's ``models/gaussians.py``.  The layout is the
reference's ``gauss_params``: ``means`` [C, 3], ``scales`` [C, 3] log-space,
``quats`` [C, 4] wxyz, ``opacities`` [C, 1] logit-space, ``features_dc``
[C, 3], ``features_rest`` [C, K-1, 3] and optional ``distill_features``
[C, L], allocated at a capacity C >= N with an ``alive`` mask.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.device import resolve_device

GaussianParams = Dict[str, torch.Tensor]

# Trailing shape of every per-Gaussian entry; None is a free width.
_LAYOUT = {
    "means": (3,),
    "scales": (3,),
    "quats": (4,),
    "opacities": (1,),
    "features_dc": (3,),
    "features_rest": (None, 3),
    "distill_features": (None,),
}
_REQUIRED = ("means", "scales", "quats", "opacities", "features_dc",
             "features_rest")


def params_from_numpy(params: Dict[str, np.ndarray],
                      device=None) -> GaussianParams:
    """Tensors from the JAX package's parameter dict (as numpy arrays).

    Checks that every entry is float32 with the layout above and one common
    leading dimension; ``features_rest`` must hold 0, 3, 8 or 15 bases.
    """
    dev = resolve_device(device)
    missing = [k for k in _REQUIRED if k not in params]
    unknown = [k for k in params if k not in _LAYOUT]
    if missing or unknown:
        raise ValueError(f"params_from_numpy: missing {missing}, "
                         f"unknown {unknown}")
    n = None
    out = {}
    for name, x in params.items():
        x = np.asarray(x)
        if x.dtype != np.float32:
            raise ValueError(f"params_from_numpy: {name} is {x.dtype}, "
                             "expected float32")
        trailing = _LAYOUT[name]
        if x.ndim != 1 + len(trailing) or any(
                want is not None and got != want
                for got, want in zip(x.shape[1:], trailing)):
            raise ValueError(f"params_from_numpy: {name} has shape "
                             f"{x.shape}, expected [N, {trailing}]")
        if n is None:
            n = x.shape[0]
        elif x.shape[0] != n:
            raise ValueError(f"params_from_numpy: {name} has {x.shape[0]} "
                             f"rows, expected {n}")
        out[name] = torch.tensor(x, device=dev)
    if out["features_rest"].shape[1] not in (0, 3, 8, 15):
        raise ValueError("params_from_numpy: features_rest must hold 0, 3, "
                         "8 or 15 SH bases")
    return out


def pad_to_capacity(params: GaussianParams, capacity: int) -> GaussianParams:
    """Pad every per-Gaussian tensor's leading dim to ``capacity``.

    Dead rows are unit quaternions, logit opacity -10 and log-scale -15
    (sub-pixel, so they never flood the binning buffer), zeros elsewhere.
    """
    out = {}
    for name, x in params.items():
        n = x.shape[0]
        if n == capacity:
            out[name] = x
            continue
        fill = torch.zeros((capacity - n,) + x.shape[1:], dtype=x.dtype,
                           device=x.device)
        if name == "quats":
            fill[:, 0] = 1.0
        elif name == "opacities":
            fill.fill_(-10.0)
        elif name == "scales":
            fill.fill_(-15.0)
        out[name] = torch.cat([x, fill], dim=0)
    return out


def activated_opacity(params: GaussianParams,
                      alive: torch.Tensor) -> torch.Tensor:
    """Sigmoid opacity [C], zeroed on dead rows."""
    return torch.sigmoid(params["opacities"][:, 0]) * alive.to(torch.float32)


def activated_scales(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params["scales"])

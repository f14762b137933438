"""Gaussian parameter dict: creation, activation, capacity, loading.

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

from ..core.sh import num_sh_bases, rgb_to_sh0
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


# Entries of the distance table made at once: rows of it are taken in
# blocks, so a cloud of 262,144 points needs 1 GiB, not its whole table.
_KNN_BLOCK = 1 << 28


def _knn3_d2(points: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Squared distances [hi - lo, 3] from points[lo:hi] to their 3 nearest
    other points: rows of the full distance table, each entry computed as
    the whole table would be, the diagonal pushed out by 1e10."""
    d2 = torch.sum((points[lo:hi, None, :] - points[None, :, :]) ** 2,
                   dim=-1)
    rows = torch.arange(hi - lo, device=points.device)
    d2[rows, rows + lo] += 1e10
    return torch.topk(d2, 3, dim=-1, largest=False).values


def init_from_points(
    points,
    colors,
    generator: torch.Generator | None,
    sh_degree: int = 3,
    capacity: int | None = None,
    init_opacity: float = 0.1,
    latent_dim: int = 0,
    device=None,
) -> tuple[GaussianParams, torch.Tensor]:
    """Splatfacto-style initialization from a point cloud [N, 3] with
    colours [N, 3] in [0, 1].

    Scales are the log of the mean distance to the 3 nearest neighbours
    (an O(N^2) distance table, in blocks of rows, at init time only);
    quaternions are normal draws from ``generator`` (on its device),
    normalized; opacities start at logit(``init_opacity``); SH rest
    coefficients at zero.

    Returns:
        (params, alive) at ``capacity`` rows (default: the point count), on
        ``device`` (the card by default).
    """
    dev = resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    colors = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    n = points.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"init_from_points: capacity {capacity} < {n} "
                         "points")
    rows = max(_KNN_BLOCK // max(n, 1), 1)
    knn = torch.cat([_knn3_d2(points, lo, min(lo + rows, n))
                     for lo in range(0, n, rows)])
    avg_dist = torch.mean(torch.sqrt(torch.clamp(knn, min=1e-12)), dim=-1)
    log_scales = torch.log(avg_dist)[:, None].repeat(1, 3)

    gen_dev = generator.device if generator is not None \
        else torch.device("cpu")
    quats = torch.randn((n, 4), generator=generator, device=gen_dev).to(dev)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)

    logit_op = float(np.log(init_opacity / (1 - init_opacity)))
    params = {
        "means": points,
        "scales": log_scales,
        "quats": quats,
        "opacities": torch.full((n, 1), logit_op, device=dev),
        "features_dc": rgb_to_sh0(colors),
        "features_rest": torch.zeros((n, num_sh_bases(sh_degree) - 1, 3),
                                     device=dev),
    }
    if latent_dim:
        params["distill_features"] = torch.zeros((n, latent_dim), device=dev)
    alive = torch.arange(capacity, device=dev) < n
    return pad_to_capacity(params, capacity), alive


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


def grow_capacity(params: GaussianParams, alive: torch.Tensor,
                  new_capacity: int) -> tuple[GaussianParams, torch.Tensor]:
    """Pad the table and the alive mask to ``new_capacity`` rows (the new
    rows dead)."""
    out = pad_to_capacity(params, new_capacity)
    grown = torch.zeros(new_capacity, dtype=alive.dtype, device=alive.device)
    grown[:alive.shape[0]] = alive
    return out, grown


def num_alive(alive: torch.Tensor) -> torch.Tensor:
    return torch.sum(alive.to(torch.int32))


def activated_opacity(params: GaussianParams,
                      alive: torch.Tensor) -> torch.Tensor:
    """Sigmoid opacity [C], zeroed on dead rows."""
    return torch.sigmoid(params["opacities"][:, 0]) * alive.to(torch.float32)


def activated_scales(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params["scales"])

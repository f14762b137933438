"""Dense TSDF fusion: the default mesh-extraction volume.

Counterpart of the JAX package's ``meshing/tsdf.py`` (the reference's
Open3D ``ScalableTSDFVolume`` as a dense [X, Y, Z] grid: voxel 0.01,
sdf_trunc 0.03, one weighted Curless-Levoy update per rendered frame).
The volume lives on one device as tensors; an update is a gather of the
frame's pixels and an elementwise running average, with no scatter, so
it is deterministic on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.cameras import Camera
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """Field names and defaults are the JAX package's."""

    voxel_size: float = 0.01
    sdf_trunc: float = 0.03
    depth_trunc: float = 1.0      # ignore depth beyond this (depth_trunc)
    origin: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    dims: Tuple[int, int, int] = (200, 200, 200)
    feature_dim: int = 0          # optional extra channels (latents)


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor      # [X, Y, Z] truncated signed distance in [-1, 1]
    weight: torch.Tensor    # [X, Y, Z]
    color: torch.Tensor     # [X, Y, Z, 3]
    features: Optional[torch.Tensor]  # [X, Y, Z, F] or None


def create_volume(config: TSDFConfig, device=None) -> TSDFVolume:
    """An empty volume on ``device`` (the card by default)."""
    dev = resolve_device(device)
    dims = tuple(config.dims)
    feats = (torch.zeros(dims + (config.feature_dim,), device=dev)
             if config.feature_dim else None)
    return TSDFVolume(
        tsdf=torch.ones(dims, device=dev),
        weight=torch.zeros(dims, device=dev),
        color=torch.zeros(dims + (3,), device=dev),
        features=feats,
    )


def volume_from_bounds(
    lo: np.ndarray, hi: np.ndarray, voxel_size: float = 0.01,
    sdf_trunc: float = 0.03, depth_trunc: float = 1.0, feature_dim: int = 0,
    max_dim: int = 384, device=None,
) -> Tuple[TSDFConfig, TSDFVolume]:
    """Build a config + volume covering [lo, hi] with bounded resolution."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    dims = np.ceil((hi - lo) / voxel_size).astype(int) + 1
    scalef = max(dims.max() / max_dim, 1.0)
    voxel_size = float(voxel_size * scalef)
    dims = np.minimum(np.ceil((hi - lo) / voxel_size).astype(int) + 1, max_dim)
    cfg = TSDFConfig(
        voxel_size=voxel_size,
        sdf_trunc=max(sdf_trunc, 3 * voxel_size),
        depth_trunc=depth_trunc,
        origin=tuple(float(x) for x in lo),
        dims=tuple(int(d) for d in dims),
        feature_dim=feature_dim,
    )
    return cfg, create_volume(cfg, device)


def voxel_centers(config: TSDFConfig, device) -> torch.Tensor:
    """World positions [V, 3] of the voxel centres, x-major: the same for
    every frame, so :func:`integrate` takes them once per volume."""
    axes = [torch.arange(d, dtype=torch.float32, device=device)
            * config.voxel_size + o
            for d, o in zip(config.dims, config.origin)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return grid.reshape(-1, 3)


def integrate(
    volume: TSDFVolume,
    depth: torch.Tensor,
    rgb: torch.Tensor,
    camera: Camera,
    config: TSDFConfig,
    features: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    alpha_thresh: float = 0.5,
    points: Optional[torch.Tensor] = None,
) -> TSDFVolume:
    """Integrate one rendered (depth, rgb[, features]) frame.

    Standard Curless-Levoy weighted TSDF update: each voxel center is
    projected into the camera; voxels within ``sdf_trunc`` behind the
    observed surface along the ray update their running averages.
    ``points`` are the volume's :func:`voxel_centers`, built here when not
    given.
    """
    dims = tuple(config.dims)
    pts = voxel_centers(config, volume.tsdf.device) if points is None \
        else points

    # The camera position one rounded product and sum at a time: the same
    # bits on the CPU and the card (a K = 3 matmul rounds as its library
    # does, and XLA itself rounds it one way eagerly and another jitted).
    w2c = camera.viewmat()
    R, t = w2c[:3, :3], w2c[:3, 3]
    x, y, zw = pts[:, 0], pts[:, 1], pts[:, 2]
    p_cam = [x * R[i, 0] + y * R[i, 1] + zw * R[i, 2] + t[i]
             for i in range(3)]
    z = p_cam[2]
    zc = torch.clamp(z, min=1e-6)
    u = camera.fx * p_cam[0] / zc + camera.cx
    v = camera.fy * p_cam[1] / zc + camera.cy

    # Near the camera plane u and v reach ~1e12, where a float -> int32
    # cast is undefined in PyTorch (the JAX code casts, then clips).  Clamp
    # in float first: every voxel inside the image, the only ones that
    # update, gets JAX's indices, and every other one an index in range.
    width, height = camera.width, camera.height
    ui = torch.clamp(torch.floor(torch.clamp(u, -1.0, float(width))).to(
        torch.int64), 0, width - 1)
    vi = torch.clamp(torch.floor(torch.clamp(v, -1.0, float(height))).to(
        torch.int64), 0, height - 1)
    in_image = ((z > 1e-6) & (u >= 0.0) & (u < width)
                & (v >= 0.0) & (v < height))
    pix = vi * width + ui

    d_obs = depth.reshape(-1)[pix]
    valid_depth = (d_obs > 1e-6) & (d_obs < config.depth_trunc)
    if alpha is not None:
        valid_depth = valid_depth & (alpha.reshape(-1)[pix] > alpha_thresh)

    sdf = (d_obs - z) / config.sdf_trunc
    update = in_image & valid_depth & (sdf > -1.0)
    sdf = torch.clamp(sdf, -1.0, 1.0)

    w_old = volume.weight.reshape(-1)
    w_new = w_old + update.to(torch.float32)
    w_safe = torch.clamp(w_new, min=1.0)

    def running_avg(old_flat, obs):
        """Weighted running average on updated voxels; others unchanged."""
        tail = (1,) * (obs.dim() - 1)
        upd = update.reshape(update.shape + tail)
        wo = w_old.reshape(w_old.shape + tail)
        ws = w_safe.reshape(w_safe.shape + tail)
        return torch.where(upd, (old_flat * wo + obs) / ws, old_flat)

    tsdf_new = running_avg(volume.tsdf.reshape(-1), sdf)
    color_new = running_avg(volume.color.reshape(-1, 3),
                            rgb.reshape(-1, 3)[pix])

    feats_new = volume.features
    if features is not None and volume.features is not None:
        f = features.shape[-1]
        feats_new = running_avg(
            volume.features.reshape(-1, f), features.reshape(-1, f)[pix]
        ).reshape(volume.features.shape)

    return TSDFVolume(
        tsdf=tsdf_new.reshape(dims),
        weight=w_new.reshape(dims),
        color=color_new.reshape(dims + (3,)),
        features=feats_new,
    )

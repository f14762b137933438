"""Synthetic scenes: random Gaussians and orbit camera rigs.

Counterpart of the JAX package's ``data/synthetic.py``.  Draws come from an
explicit ``torch.Generator``; they differ from ``jax.random``'s, so tests
that compare the two packages build one scene with numpy and hand it to
both (``models/gaussians.py::params_from_numpy``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.cameras import Camera, make_camera
from ..core.sh import num_sh_bases, rgb_to_sh0
from ..utils.device import resolve_device


def random_gaussian_params(
    generator: Optional[torch.Generator],
    n: int,
    sh_degree: int = 0,
    extent: float = 1.0,
    scale_range: tuple = (0.01, 0.05),
    latent_dim: int = 0,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Raw (pre-activation) Gaussian parameters in the reference layout.

    The draws run on the generator's device (the CPU for a default
    ``torch.Generator()``), so one seed gives one scene on every device;
    the result is moved to ``device`` (the card by default).
    """
    dev = resolve_device(device)
    gen_dev = generator.device if generator is not None else torch.device(
        "cpu")

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=gen_dev)
        return lo + (hi - lo) * u

    means = uniform((n, 3), -extent, extent)
    log_scales = torch.log(uniform((n, 3), scale_range[0], scale_range[1]))
    quats = torch.randn((n, 4), generator=generator, device=gen_dev)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opacities = uniform((n, 1), 0.5, 3.0)
    rgb = uniform((n, 3), 0.1, 0.9)
    rest = 0.01 * torch.randn((n, num_sh_bases(sh_degree) - 1, 3),
                              generator=generator, device=gen_dev)
    params = {
        "means": means,
        "scales": log_scales,
        "quats": quats,
        "opacities": opacities,
        "features_dc": rgb_to_sh0(rgb),
        "features_rest": rest,
    }
    if latent_dim:
        params["distill_features"] = torch.zeros((n, latent_dim))
    return {k: v.to(device=dev, dtype=torch.float32)
            for k, v in params.items()}


def look_at_c2w(eye: np.ndarray, target: np.ndarray, up=None) -> np.ndarray:
    """OpenGL camera-to-world [4, 4] looking from ``eye`` toward ``target``."""
    up = np.array([0.0, 0.0, 1.0]) if up is None else np.asarray(up, np.float64)
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    # OpenGL: x right, y up, z backward (-forward).
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def orbit_cameras(
    n_cams: int,
    radius: float = 3.0,
    width: int = 128,
    height: int = 128,
    focal: float | None = None,
    elevation: float = 0.4,
    target=(0.0, 0.0, 0.0),
    device=None,
) -> List[Camera]:
    """Cameras orbiting ``target`` -- the synthetic stand-in for SfM poses."""
    target = np.asarray(target, np.float64)
    focal = focal if focal is not None else 1.2 * max(width, height)
    cams = []
    for i in range(n_cams):
        ang = 2.0 * np.pi * i / max(n_cams, 1)
        eye = target + radius * np.array(
            [np.cos(ang), np.sin(ang), np.sin(elevation)])
        cams.append(make_camera(focal, focal, width / 2.0, height / 2.0,
                                width, height, look_at_c2w(eye, target),
                                device=device))
    return cams


def flat_disk_gaussian(center=(0.0, 0.0, 0.0), normal=(0.0, 0.0, 1.0),
                       radius=0.3, thickness=1e-3,
                       device=None) -> Dict[str, torch.Tensor]:
    """One flat disk Gaussian with a known geometric normal: raw
    parameters with scales (radius, radius, thickness) and the rotation
    whose z-axis is ``normal``, as the JAX package's function builds it."""
    dev = resolve_device(device)
    normal = np.asarray(normal, np.float64)
    normal = normal / np.linalg.norm(normal)
    # Build rotation with z-axis = normal, convert to wxyz quaternion.
    helper = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(helper, normal)) > 0.9:
        helper = np.array([0.0, 1.0, 0.0])
    x = np.cross(helper, normal)
    x = x / np.linalg.norm(x)
    y = np.cross(normal, x)
    R = np.stack([x, y, normal], axis=1)
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2.0
    quat = np.array([
        w,
        (R[2, 1] - R[1, 2]) / (4 * w),
        (R[0, 2] - R[2, 0]) / (4 * w),
        (R[1, 0] - R[0, 1]) / (4 * w),
    ])

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return {
        "means": f32([center]),
        "scales": torch.log(f32([[radius, radius, thickness]])),
        "quats": f32([quat]),
        "opacities": f32([[4.0]]),   # sigmoid(4) ~ 0.982
        "features_dc": rgb_to_sh0(f32([[0.8, 0.2, 0.2]])),
        "features_rest": torch.zeros((1, 0, 3), dtype=torch.float32,
                                     device=dev),
    }

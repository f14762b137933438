"""Camera-pose optimization: per-camera SO3xR3 adjustments.

Counterpart of the JAX package's ``train/camera_opt.py``: nerfstudio's
``CameraOptimizer`` as the reference trains it (the ``camera_opt`` Adam
group: lr 1e-4 -> 5e-7 with sine warmup), a learned 6-DoF delta per
training camera applied to the camera-to-world transform before
rendering.  The rasterizer is differentiable in the view matrix
(``Camera.viewmat`` and the projection's ``R_wc``/``t_wc``), so the
deltas train with everything else.  Their gradient is a sum over every
Gaussian, taken by products and ``sum`` (no scatter), so a step repeats
bit for bit on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.cameras import Camera
from ..utils.device import resolve_device
from .optim import GroupSpec

CAMERA_OPT_GROUP = GroupSpec(
    lr=1e-4, lr_final=5e-7, max_steps=30000, warmup_steps=1000,
    lr_pre_warmup=0.0,
)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[3, 3] cross-product matrix of a [3] vector."""
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [3] axis-angle -> [3, 3] rotation (small-angle safe)."""
    theta = torch.sqrt(torch.sum(omega * omega) + 1e-20)
    kx = _skew(omega / theta)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    r = eye + torch.sin(theta) * kx + (1.0 - torch.cos(theta)) * (kx @ kx)
    # First-order fallback at theta ~ 0 keeps gradients clean.
    return torch.where(theta < 1e-6, eye + _skew(omega), r)


def apply_pose_adjustment(camera: Camera, delta: torch.Tensor) -> Camera:
    """Apply a 6-DoF delta [omega(3), tau(3)] to the camera-to-world pose."""
    rot = exp_so3(delta[:3])
    c2w = camera.c2w
    new_r = rot @ c2w[:3, :3]
    new_t = rot @ c2w[:3, 3] + delta[3:]
    top = torch.cat([new_r, new_t[:, None]], dim=1)
    return dataclasses.replace(camera, c2w=torch.cat([top, c2w[3:]], dim=0))


def init_camera_opt(num_cameras: int, device=None) -> torch.Tensor:
    return torch.zeros((num_cameras, 6), dtype=torch.float32,
                       device=resolve_device(device))

"""Pinhole cameras and the OpenGL -> COLMAP convention change.

Counterpart of the JAX package's ``core/cameras.py``.  A camera is a plain
dataclass holding two tensors; ``width`` and ``height`` are Python ints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single pinhole camera.

    Attributes:
        K: [3, 3] float32 intrinsics ``[[fx, 0, cx], [0, fy, cy], [0, 0, 1]]``.
        c2w: [4, 4] float32 camera-to-world in the OpenGL convention
            (y up, z backward), as in nerfstudio's ``transforms.json``.
        width, height: image size in pixels.
    """

    K: torch.Tensor
    c2w: torch.Tensor
    width: int = 0
    height: int = 0

    @property
    def fx(self) -> torch.Tensor:
        return self.K[0, 0]

    @property
    def fy(self) -> torch.Tensor:
        return self.K[1, 1]

    @property
    def cx(self) -> torch.Tensor:
        return self.K[0, 2]

    @property
    def cy(self) -> torch.Tensor:
        return self.K[1, 2]

    def viewmat(self) -> torch.Tensor:
        """World-to-camera [4, 4] in the COLMAP convention (y down, z fwd)."""
        return opengl_c2w_to_colmap_w2c(self.c2w)

    def camera_center(self) -> torch.Tensor:
        """Camera position in world coordinates, [3]."""
        return self.c2w[:3, 3]


def make_camera(fx: float, fy: float, cx: float, cy: float, width: int,
                height: int, c2w, device=None) -> Camera:
    """Camera from scalar intrinsics and a [4, 4] or [3, 4] c2w."""
    dev = resolve_device(device)
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
    if c2w.shape == (3, 4):
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32,
                              device=dev)
        c2w = torch.cat([c2w, bottom], dim=0)
    return Camera(K=K, c2w=c2w, width=int(width), height=int(height))


def camera_from_numpy(K: np.ndarray, c2w: np.ndarray, width: int,
                      height: int, device=None) -> Camera:
    """Camera from the JAX package's arrays (K [3, 3], c2w [4, 4])."""
    K = np.asarray(K)
    c2w = np.asarray(c2w)
    if K.shape != (3, 3) or c2w.shape != (4, 4):
        raise ValueError(f"expected K [3, 3] and c2w [4, 4], got {K.shape} "
                         f"and {c2w.shape}")
    dev = resolve_device(device)
    return Camera(
        K=torch.as_tensor(K.astype(np.float32), device=dev),
        c2w=torch.as_tensor(c2w.astype(np.float32), device=dev),
        width=int(width), height=int(height),
    )


# OpenGL (y up, z back) -> COLMAP/OpenCV (y down, z forward): negate y and z.
_GL_TO_CV_DIAG = (1.0, -1.0, -1.0)


def opengl_c2w_to_colmap_w2c(c2w_gl: torch.Tensor) -> torch.Tensor:
    """OpenGL camera-to-world -> COLMAP world-to-camera (viewmat), using the
    closed-form rigid inverse ``[R | t]^-1 = [R^T | -R^T t]``."""
    diag = torch.tensor(_GL_TO_CV_DIAG, dtype=c2w_gl.dtype,
                        device=c2w_gl.device)
    R = c2w_gl[:3, :3] * diag[None, :]
    t = c2w_gl[:3, 3]
    R_inv = R.T
    w2c = torch.zeros((4, 4), dtype=c2w_gl.dtype, device=c2w_gl.device)
    w2c[:3, :3] = R_inv
    w2c[:3, 3] = -(R_inv @ t)
    w2c[3, 3] = 1.0
    return w2c

"""Pinhole cameras, the OpenGL -> COLMAP convention change, and normal
maps from depth maps (the RaDe-GS depth-normal consistency loss).

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

    def resized(self, factor: float) -> "Camera":
        """The camera rendering at ``1/factor`` of the resolution: rounded
        sizes, the first two rows of K scaled."""
        scale = 1.0 / factor
        K = self.K.clone()
        K[:2] *= scale
        return dataclasses.replace(self, K=K,
                                   width=int(round(self.width * scale)),
                                   height=int(round(self.height * scale)))

    def downscaled(self, factor: int) -> "Camera":
        """The camera at 1/``factor`` of the resolution: floor-division
        sizes (so an image box-filtered by ``factor`` and the camera agree
        for odd sizes too), the first two rows of K scaled."""
        if factor <= 1:
            return self
        K = self.K.clone()
        K[:2] *= 1.0 / factor
        return dataclasses.replace(self, K=K, width=self.width // factor,
                                   height=self.height // factor)


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


def stack_cameras(cameras) -> Camera:
    """One :class:`Camera` holding a batch of same-sized cameras: K [B, 3,
    3] and c2w [B, 4, 4] (``ops/rasterize.py::render_tiled_batch``)."""
    cameras = list(cameras)
    sizes = {(c.width, c.height) for c in cameras}
    if len(sizes) != 1:
        raise ValueError(f"cameras of different sizes {sorted(sizes)}")
    return Camera(K=torch.stack([c.K for c in cameras]),
                  c2w=torch.stack([c.c2w for c in cameras]),
                  width=cameras[0].width, height=cameras[0].height)


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


def focal2fov(focal: float, pixels: int) -> float:
    """Field of view (radians) of ``pixels`` at focal length ``focal``."""
    return 2.0 * float(np.arctan(pixels / (2.0 * focal)))


def fov2focal(fov: float, pixels: int) -> float:
    """Focal length giving field of view ``fov`` (radians) over
    ``pixels``."""
    return pixels / (2.0 * float(np.tan(fov / 2.0)))


def pixel_centers(width: int, height: int, device=None):
    """Pixel-centre coordinate grids ``(u, v)``, each [H, W]."""
    u = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    v = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    return (u[None, :].expand(height, width),
            v[:, None].expand(height, width))


def camera_rays(camera: Camera) -> torch.Tensor:
    """Per-pixel camera-space ray directions ``K^-1 (u, v, 1)``, [H, W, 3],
    with z = 1 so that ``depth * ray`` is the point at that z-depth."""
    u, v = pixel_centers(camera.width, camera.height, camera.K.device)
    x = (u - camera.cx) / camera.fx
    y = (v - camera.cy) / camera.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def depth_to_points(camera: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Back-project a z-depth map [H, W] to camera-space points [H, W, 3]."""
    depth = depth.reshape(camera.height, camera.width)
    return camera_rays(camera) * depth[..., None]


def points_to_normal(points: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normals from camera-space points [H, W, 3] by central differences:
    the derivative along the rows crossed with the one along the columns,
    normalized; the one-pixel border is zero."""
    d_row = points[2:, 1:-1, :] - points[:-2, 1:-1, :]
    d_col = points[1:-1, 2:, :] - points[1:-1, :-2, :]
    n = torch.linalg.cross(d_row, d_col, dim=-1)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + eps)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def depth_pair_to_normal(camera: Camera, depth1: torch.Tensor,
                         depth2: torch.Tensor) -> torch.Tensor:
    """Normal maps of two depth maps, stacked [2, H, W, 3]: index 0 from
    ``depth1`` (expected depth), index 1 from ``depth2`` (median depth)."""
    n1 = points_to_normal(depth_to_points(camera, depth1))
    n2 = points_to_normal(depth_to_points(camera, depth2))
    return torch.stack([n1, n2], dim=0)

"""Per-image bilateral-grid appearance correction.

Counterpart of the JAX package's ``train/bilateral.py``: Splatfacto's
bilateral grid (the ``bilateral_grid`` Adam group of the reference's
optimizer table).  Each training image owns a small 3D grid over
(guidance luminance, y, x) of 3x4 affine colour transforms, sliced
trilinearly per pixel and applied to the rendered RGB, absorbing per-frame
exposure and white balance; a total-variation term keeps the grids smooth.

The JAX package slices by gathering eight grid rows per pixel.  A
gather's autograd backward would scatter-add H * W * 8 rows into the
[gz * gy * gx, 12] grid, a float atomic add on the card whose sums land in
another order on every run; and the sorted segment sum (kernel 4), which
holds such sums in a fixed order, sums each of the grid's 2,048 cells'
thousands of rows in one sequence (35.6 ms at 1280x720 on an H100).  So
the slice is three dense contractions with the trilinear weights as
matrices (two nonzeros a row): over x ([W, gx]), over y ([H, gy]), then
over z per pixel ([H, W, gz]).  Their backward is products and sums too:
no scatter, no atomics, the same bits on every run.

The x and y sample positions are the JAX package's ``jnp.linspace`` as XLA
computes it on the CPU: ``i * (stop * (1 / (n - 1)))`` in float32, the
last one ``stop``.  ``torch.linspace`` rounds some positions otherwise,
which moves ``floor`` at an integer.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from ..utils.device import resolve_device
from .optim import GroupSpec

BILATERAL_GROUP = GroupSpec(
    lr=2e-3, lr_final=1e-4, max_steps=30000, warmup_steps=1000,
    lr_pre_warmup=0.0,
)

_LUMA = (0.299, 0.587, 0.114)


def init_bilateral_grids(num_images: int, grid_x: int = 16, grid_y: int = 16,
                         grid_z: int = 8, device=None) -> torch.Tensor:
    """[N, gz, gy, gx, 12] grids initialized to the identity transform."""
    ident = torch.cat([torch.eye(3).reshape(-1), torch.zeros(3)])
    return ident.repeat(num_images, grid_z, grid_y, grid_x, 1).to(
        resolve_device(device), torch.float32)


def sample_positions(stop: float, n: int, device=None) -> torch.Tensor:
    """[n] float32 positions from 0 to ``stop``: ``jnp.linspace(0, stop,
    n)`` as XLA computes it (see the module docstring)."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.tensor(stop, dtype=torch.float32) * (
        torch.tensor(1.0, dtype=torch.float32) / (n - 1))
    pos = torch.arange(n - 1, dtype=torch.float32) * step
    return torch.cat([pos, torch.tensor([stop], dtype=torch.float32)]).to(
        device)


def _tent(p0: torch.Tensor, t: torch.Tensor, n: int) -> torch.Tensor:
    """Linear interpolation weights [..., n] of positions ``p0 + t``: 1 - t
    at cell ``p0``, t at ``p0 + 1``, 0 elsewhere."""
    return (F.one_hot(p0.long(), n).to(t.dtype) * (1.0 - t)[..., None]
            + F.one_hot(p0.long() + 1, n).to(t.dtype) * t[..., None])


def apply_bilateral_grid(grid: torch.Tensor,
                         rgb: torch.Tensor) -> torch.Tensor:
    """Slice one image's grid [gz, gy, gx, 12] at each pixel and apply the
    affine transform.  ``rgb`` is [H, W, 3] in [0, 1]."""
    gz, gy, gx, _ = grid.shape
    h, w = rgb.shape[:2]
    dev = rgb.device
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=dev)
    guide = torch.clamp(torch.einsum("hwc,c->hw", rgb, luma), 0.0, 1.0)

    fx = sample_positions(gx - 1.0, w, dev)
    fy = sample_positions(gy - 1.0, h, dev)
    fz = guide * (gz - 1.0)

    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, gx - 2)
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, gy - 2)
    z0 = torch.clamp(torch.floor(fz).to(torch.int32), 0, gz - 2)
    wx = _tent(x0, fx - x0, gx)                              # [W, gx]
    wy = _tent(y0, fy - y0, gy)                              # [H, gy]
    wz = _tent(z0, fz - z0, gz)                              # [H, W, gz]
    c = torch.einsum("zyxk,wx->zykw", grid, wx)
    c = torch.einsum("zykw,hy->hzkw", c, wy)
    c = torch.einsum("hzkw,hwz->hwk", c, wz)                 # [H, W, 12]
    mat = c[..., :9].reshape(h, w, 3, 3)
    bias = c[..., 9:]
    out = torch.einsum("hwij,hwj->hwi", mat, rgb) + bias
    return torch.clamp(out, 0.0, 1.0)


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared difference between neighboring grid cells, all axes."""
    tv = 0.0
    for axis in (1, 2, 3):
        d = torch.diff(grids, dim=axis)
        tv = tv + torch.mean(d * d)
    return tv

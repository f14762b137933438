"""Loss stack of RaDe-GS training.

Counterpart of the JAX package's ``train/losses.py``:

* RGB loss = (1 - ssim_lambda) * L1 + ssim_lambda * (1 - SSIM);
* depth-normal consistency: lambda * [(1 - r) mean(E_depth) + r
  mean(E_middepth)];
* scale regularization: a penalty on anisotropy beyond ``max_gauss_ratio``;
* rade-features' cosine distillation of decoded feature maps.

SSIM filters with a separable 11-tap Gaussian as two depthwise
``conv2d(groups=C)`` passes; the JAX package's two filter variants
(depthwise conv, banded matmul) are the same linear operator.  TF32 is off
for cuDNN (package ``__init__``), as the JAX code pins ``HIGHEST`` here:
the filters feed the cancellation E[x^2] - E[x]^2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


_WINDOW_1D = _gaussian_window_1d()


@functools.lru_cache(maxsize=None)
def _window(device: torch.device) -> torch.Tensor:
    """:data:`_WINDOW_1D` on ``device``, copied there once: a copy from the
    host each call would wait for the card's queue to drain."""
    with torch.inference_mode(False):
        return torch.as_tensor(_WINDOW_1D, device=device)


def _filter2d(img: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' Gaussian filter of [H, W, C].  An image with a
    side under the window gives an empty map, as JAX's VALID convolution
    does (so SSIM is the NaN mean of nothing, with zero gradient)."""
    h, w, c = img.shape
    k = _WINDOW_1D.shape[0]
    if h < k or w < k:
        return img[:max(h - k + 1, 0), :max(w - k + 1, 0)]
    win = _window(img.device)
    x = img.permute(2, 0, 1)[None]                       # [1, C, H, W]
    y = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    y = F.conv2d(y, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return y[0].permute(1, 2, 0)                         # [H', W', C]


def ssim(img0: torch.Tensor, img1: torch.Tensor, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair (11x11 Gaussian window)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu0 = _filter2d(img0)
    mu1 = _filter2d(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _filter2d(img0 * img0) - mu00
    s11 = _filter2d(img1 * img1) - mu11
    s01 = _filter2d(img0 * img1) - mu01
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den)


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor,
             ssim_lambda: float = 0.2) -> torch.Tensor:
    """Splatfacto main loss: (1 - l) L1 + l (1 - SSIM)."""
    l1 = torch.mean(torch.abs(pred - gt))
    return (1.0 - ssim_lambda) * l1 + ssim_lambda * (1.0 - ssim(pred, gt))


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def depth_normal_loss(depth_error_map: torch.Tensor,
                      middepth_error_map: torch.Tensor,
                      depth_ratio: float = 0.6,
                      depth_normal_lambda: float = 0.05) -> torch.Tensor:
    """RaDe-GS depth-normal consistency loss."""
    loss = (1.0 - depth_ratio) * torch.mean(depth_error_map) \
        + depth_ratio * torch.mean(middepth_error_map)
    return depth_normal_lambda * loss


def scale_regularization(log_scales: torch.Tensor, alive: torch.Tensor,
                         max_gauss_ratio: float = 10.0) -> torch.Tensor:
    """Penalize Gaussians more anisotropic than ``max_gauss_ratio``;
    ``alive`` is a float [C] mask."""
    s = torch.exp(log_scales)
    ratio = torch.amax(s, dim=-1) / torch.clamp(torch.amin(s, dim=-1),
                                                min=1e-12)
    pen = torch.clamp(ratio, min=max_gauss_ratio) - max_gauss_ratio
    denom = torch.clamp(torch.sum(alive), min=1.0)
    return 0.1 * torch.sum(pen * alive) / denom


def cosine_distillation_loss(pred: torch.Tensor,
                             gt: torch.Tensor) -> torch.Tensor:
    """Mean (1 - cosine similarity) over the channel axis 0 of [C, H, W]
    maps, with 1e-16 inside each norm's square root."""
    num = torch.sum(pred * gt, dim=0)
    den = torch.sqrt(torch.sum(pred * pred, dim=0) + 1e-16) \
        * torch.sqrt(torch.sum(gt * gt, dim=0) + 1e-16)
    return torch.mean(1.0 - num / den)

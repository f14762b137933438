"""LPIPS perceptual metric (VGG16 backbone).

Counterpart of the JAX package's ``utils/lpips.py``.  The reference
inherits LPIPS from Splatfacto's eval metrics (nerfstudio computes PSNR,
SSIM and LPIPS per eval image).  Architecture (Zhang et al. 2018): the
thirteen VGG16 convolutions with ReLU and 2x2 max pools, unit-normalised
activations at relu{1_2, 2_2, 3_3, 4_3, 5_3}, per-channel learned linear
heads ``lin{i}``, a spatial mean, summed over the five stages.  The two
images run as one batch of two, in float32 (the port turns TF32 off at
import).

Weights come from ``scripts/convert_weights.py vgg16`` (torchvision VGG16
and the lpips package's linear heads), found by
``features/weights.py::find_weights("vgg16_lpips.npz")``.  Without the file
the metric is unavailable: callers check :func:`lpips_available`, and
:func:`lpips` raises (no meaningless random-weight metric is reported).
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..features.weights import find_weights
from .device import resolve_device

# ImageNet normalization as used inside the lpips package ("scaling layer").
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# Stage boundaries: conv index (into the 13 VGG16 convs) after which each
# LPIPS stage ends; max-pool after stages 0..3.
_STAGE_ENDS = (1, 3, 6, 9, 12)


def lpips_available() -> bool:
    return find_weights("vgg16_lpips.npz") is not None


@functools.lru_cache(maxsize=2)
def _load_params(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k: torch.tensor(data[k], dtype=torch.float32, device=device)
                for k in data.files}


def _vgg_stages(params: Dict[str, torch.Tensor],
                x: torch.Tensor) -> List[torch.Tensor]:
    """x: [B, H, W, 3] in [-1, 1] (the lpips input convention).  Returns
    the five stage activation maps, each [B, C, h, w]."""
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=x.device)
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=x.device)
    x = ((x - shift) / scale).permute(0, 3, 1, 2).contiguous()   # NCHW
    stages = []
    conv_j = 0
    for stage in range(5):
        while True:
            x = F.relu(F.conv2d(x, params[f"conv{conv_j}.w"],
                                params[f"conv{conv_j}.b"], padding=1))
            end_of_stage = conv_j == _STAGE_ENDS[stage]
            conv_j += 1
            if end_of_stage:
                break
        stages.append(x)
        if stage < 4:
            x = F.max_pool2d(x, 2, 2)
    return stages


def _lpips_pair(params: Dict[str, torch.Tensor], a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """LPIPS of two [H, W, 3] images in [-1, 1], a scalar tensor."""
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for i, f in enumerate(_vgg_stages(params, torch.stack([a, b]))):
        n = f * torch.rsqrt(torch.sum(f * f, 1, keepdim=True) + 1e-10)
        d = (n[0] - n[1]) ** 2                                # [C, h, w]
        lin = params[f"lin{i}"]
        total = total + torch.mean(torch.sum(d * lin[:, None, None], dim=0))
    return total


@torch.no_grad()
def lpips(img0, img1, device=None) -> float:
    """LPIPS distance between two [H, W, 3] images in [0, 1] (tensors or
    numpy arrays), computed on ``img0``'s device when it is a tensor, else
    on ``device`` (the card by default).

    Raises ``RuntimeError`` when no converted VGG16 weights are present
    (see the module docstring).
    """
    path = find_weights("vgg16_lpips.npz")
    if path is None:
        raise RuntimeError(
            "LPIPS needs converted VGG16 weights: run "
            "scripts/convert_weights.py vgg16 and place vgg16_lpips.npz "
            "under weights/ (see features/weights.py for search paths).")
    dev = img0.device if isinstance(img0, torch.Tensor) \
        else resolve_device(device)
    params = _load_params(path, dev)

    def prep(img):
        t = torch.as_tensor(np.asarray(img, np.float32)) \
            if not isinstance(img, torch.Tensor) else img
        return t.detach().to(dev, torch.float32) * 2.0 - 1.0

    return float(_lpips_pair(params, prep(img0), prep(img1)))

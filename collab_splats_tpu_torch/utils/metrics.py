"""Quantitative metrics + Gaussian->pixel projection lookup.

Counterpart of the JAX package's ``utils/metrics.py`` (the reference's
``project_gaussians``, mesh ``calculate_accuracy`` /
``calculate_completeness`` on a KD-tree, and ``mean_angular_error``).  The
KD-tree metrics are host code (scipy), as in JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..ops.rasterize import RenderMeta


def project_gaussians(meta: RenderMeta) -> Dict[str, np.ndarray]:
    """Flat-pixel lookup arrays for every Gaussian in a render.

    Mirrors the reference's consumption of the gsplat ``info`` dict:
    visibility from radius > 1, rounded 2D centers clamped into the image,
    flattened to ``x + y * W``.
    """
    w, h = meta.width, meta.height
    radii = meta.proj.radius.detach().cpu().numpy()
    valid_mask = radii > 1.0
    gaussian_ids = np.nonzero(valid_mask)[0]

    xy = np.round(meta.proj.mean2d.detach().cpu().numpy()).astype(np.int64)
    x = np.clip(xy[:, 0], 0, w - 1)
    y = np.clip(xy[:, 1], 0, h - 1)
    return {
        "proj_flattened": x + y * w,
        "proj_depths": meta.proj.depth.detach().cpu().numpy(),
        "valid_mask": valid_mask,
        "gaussian_ids": gaussian_ids,
    }


def calculate_accuracy(
    reconstructed_points: np.ndarray,
    reference_points: np.ndarray,
    percentile: float = 90,
) -> float:
    """Distance below which ``percentile``% of reconstructed points lie from
    the reference cloud."""
    tree = cKDTree(np.asarray(reference_points))
    distances, _ = tree.query(np.asarray(reconstructed_points))
    return float(np.percentile(distances, percentile))


def calculate_completeness(
    reconstructed_points: np.ndarray,
    reference_points: np.ndarray,
    threshold: float = 0.05,
) -> float:
    """Percentage of reference points within ``threshold`` of the
    reconstruction."""
    tree = cKDTree(np.asarray(reconstructed_points))
    distances, _ = tree.query(np.asarray(reference_points))
    return float(np.sum(distances < threshold) / len(distances) * 100.0)


def mean_angular_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-pixel angular error (radians) between normal maps.

    Accepts [..., 3] maps (channel-last; the reference's [B, C, H, W]
    layout transposes into this).
    """
    dots = torch.clamp(torch.sum(pred * gt, dim=-1), -1.0, 1.0)
    return torch.arccos(dots)

"""Point-cloud cleaning without Open3D.

Counterpart of the JAX package's ``utils/pointcloud.py``, an own copy (the
module is numpy and scipy only).  Behavioural equivalents of the
reference's ``clean_pcd`` (adaptive voxel downsample with index tracing,
statistical outlier removal, distance filter), ``remove_far_points`` and
``density_filter``; every function returns surviving indices so callers
can slice parallel attribute arrays, as the reference uses its traced
indices.
"""


from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree


def voxel_downsample(
    points: np.ndarray, voxel_size: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep one representative point per voxel. Returns (points, indices)."""
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    first = np.sort(first)
    return points[first], first


def statistical_outlier_removal(
    points: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 2.0
) -> np.ndarray:
    """Indices of inliers: mean k-NN distance within mean + std_ratio*std."""
    if len(points) <= nb_neighbors:
        return np.arange(len(points))
    tree = cKDTree(points)
    d, _ = tree.query(points, k=nb_neighbors + 1)
    mean_d = d[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return np.nonzero(mean_d < thresh)[0]


def remove_far_points(
    points: np.ndarray,
    max_distance: float = 1.0,
    reference: str = "centroid",
) -> np.ndarray:
    """Indices of points within ``max_distance`` of the reference point
    ("centroid" | "origin" | "median")."""
    if reference == "origin":
        ref = np.zeros(3)
    elif reference == "median":
        ref = np.median(points, axis=0)
    else:
        ref = points.mean(axis=0)
    d = np.linalg.norm(points - ref, axis=-1)
    return np.nonzero(d <= max_distance)[0]


def density_filter(
    points: np.ndarray,
    radius: float = 0.05,
    min_neighbors: int = 5,
) -> np.ndarray:
    """Indices of points with at least ``min_neighbors`` within ``radius``."""
    tree = cKDTree(points)
    counts = np.array(tree.query_ball_point(points, radius,
                                            return_length=True))
    return np.nonzero(counts - 1 >= min_neighbors)[0]


def clean_pcd(
    points: np.ndarray,
    voxel_size: float = 0.015,
    radius: float = 0.05,
    max_distance: float = 1.0,
    downsample: bool = True,
    outlier_removal: bool = True,
    distance_removal: bool = True,
    reference: str = "centroid",
) -> Tuple[np.ndarray, np.ndarray]:
    """Full cleaning pass; returns (points, surviving original indices).

    Adaptive voxel size mirrors the reference heuristic (pointcloud.py:29-46):
    scale the voxel by local density sampled on a subset.
    """
    indices = np.arange(len(points))
    pts = np.asarray(points, np.float64)

    if downsample:
        adaptive = voxel_size
        if len(pts) > 10000:
            tree = cKDTree(pts)
            sample = pts[: min(1000, len(pts))]
            counts = tree.query_ball_point(sample, radius * 2,
                                           return_length=True)
            avg_density = float(np.mean(counts))
            adaptive = voxel_size * max(
                0.5, min(2.0, 50.0 / max(1e-6, avg_density))
            )
        pts, keep = voxel_downsample(pts, adaptive)
        indices = indices[keep]

    if outlier_removal:
        keep = statistical_outlier_removal(pts)
        pts, indices = pts[keep], indices[keep]

    if distance_removal:
        keep = remove_far_points(pts, max_distance, reference)
        pts, indices = pts[keep], indices[keep]

    return pts.astype(np.float32), indices

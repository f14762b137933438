"""Floor alignment: RANSAC plane fit -> rotate z-up -> floor at z = 0.

The port's own copy of the JAX package's ``meshing/align.py``, unchanged.

Behavioral equivalent of ``align_geometry_floor`` (utils/mesh.py:410-498),
which uses Open3D's RANSAC ``segment_plane`` then rotates the dominant
plane's normal to +z and shifts it to z = 0.  Host-side numpy (small-N,
one-shot).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def ransac_plane(
    points: np.ndarray,
    distance_threshold: float = 0.01,
    num_iterations: int = 1000,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fit a dominant plane. Returns ((a, b, c, d) with ||n||=1, inlier mask)."""
    rng = np.random.RandomState(seed)
    pts = np.asarray(points, np.float64)
    n = len(pts)
    best_inliers = -1
    best_plane = np.array([0.0, 0.0, 1.0, 0.0])
    idx = rng.randint(0, n, size=(num_iterations, 3))
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    normals = np.cross(p1 - p0, p2 - p0)
    norms = np.linalg.norm(normals, axis=-1)
    ok = norms > 1e-12
    normals[ok] /= norms[ok][:, None]
    ds = -np.sum(normals * p0, axis=-1)
    # Evaluate in blocks to bound memory.
    for i in np.nonzero(ok)[0]:
        dist = np.abs(pts @ normals[i] + ds[i])
        count = int((dist < distance_threshold).sum())
        if count > best_inliers:
            best_inliers = count
            best_plane = np.concatenate([normals[i], [ds[i]]])
    dist = np.abs(pts @ best_plane[:3] + best_plane[3])
    return best_plane, dist < distance_threshold


def floor_alignment_transform(
    points: np.ndarray,
    distance_threshold: float = 0.01,
    num_iterations: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """[4, 4] rigid transform rotating the dominant plane normal to +z and
    placing the plane at z = 0, with most geometry above the floor."""
    plane, inliers = ransac_plane(
        points, distance_threshold, num_iterations, seed
    )
    n = plane[:3]
    # Point the normal toward the majority of the geometry (up).
    centroid = points.mean(axis=0)
    if np.dot(n, centroid) + plane[3] < 0:
        n = -n
        plane = -plane
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(n, z)
    s = np.linalg.norm(v)
    c = float(np.dot(n, z))
    if s < 1e-9:
        R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
    # After rotation the plane is z = -d (for unit normal): shift to z = 0.
    T = np.eye(4)
    T[:3, :3] = R
    T[2, 3] = plane[3]
    return T


def apply_transform(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    return points @ T[:3, :3].T + T[:3, 3]

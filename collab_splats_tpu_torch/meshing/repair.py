"""Mesh clean / repair: connected components, small-component removal,
boundary-loop hole filling.

The port's own copy of the JAX package's ``meshing/repair.py``, calling
the port's ``_native`` binding of ``cpp/libmesh_repair.so``.  Where the
library cannot be built or loaded it keeps that module's numpy path: both
are host code.

Behavioral equivalent of the reference's MeshLib-based ``clean_repair_mesh``
(utils/mesh.py:359-407: keep the large components, ``fillHoleNicely``) and
``mesh_clustering`` (:523-576, Open3D ``cluster_connected_triangles``).
Pure-numpy union-find + boundary-loop fan fill; a C++ fast path (cpp/) can
replace the inner loops when mesh sizes warrant it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _union_find(n: int):
    parent = np.arange(n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    return parent, find, union


def face_components(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Label faces by connected component (via shared vertices). [F] int."""
    from . import _native

    native = _native.face_components(len(vertices), faces)
    if native is not None:
        return native.astype(np.int64)
    n = len(vertices)
    parent, find, union = _union_find(n)
    for f in faces:
        union(int(f[0]), int(f[1]))
        union(int(f[0]), int(f[2]))
    roots = np.fromiter((find(int(v)) for v in faces[:, 0]), np.int64,
                        len(faces))
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def remove_small_components(
    vertices: np.ndarray,
    faces: np.ndarray,
    min_fraction: float = 0.05,
    keep_top: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop components smaller than ``min_fraction`` of the largest (or keep
    only the ``keep_top`` largest)."""
    if len(faces) == 0:
        return vertices, faces
    labels = face_components(vertices, faces)
    counts = np.bincount(labels)
    if keep_top is not None:
        keep = np.argsort(counts)[::-1][:keep_top]
        mask = np.isin(labels, keep)
    else:
        mask = counts[labels] >= min_fraction * counts.max()
    return compact(vertices, faces[mask])


def compact(
    vertices: np.ndarray, faces: np.ndarray, extra: List[np.ndarray] = ()
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop unreferenced vertices, remapping faces (and per-vertex extras)."""
    used = np.zeros(len(vertices), bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    new_faces = remap[faces].astype(np.int32)
    if extra:
        return vertices[used], new_faces, [e[used] for e in extra]
    return vertices[used], new_faces


def boundary_loops(faces: np.ndarray) -> List[np.ndarray]:
    """Find boundary loops: cycles of edges used by exactly one face."""
    from . import _native

    b_edges = _native.boundary_edges(faces)
    if b_edges is None:
        edges = np.concatenate(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]
        )
        keys = np.sort(edges, axis=1)
        uniq, inverse, counts = np.unique(
            keys, axis=0, return_inverse=True, return_counts=True
        )
        boundary_mask = counts[inverse] == 1
        b_edges = edges[boundary_mask]  # directed as in faces
    if len(b_edges) == 0:
        return []
    nxt = {}
    for a, b in b_edges:
        nxt[int(a)] = int(b)
    loops = []
    visited = set()
    for start in list(nxt):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        cur = nxt.get(start)
        broken = False
        while cur is not None and cur != start:
            if cur in visited:
                broken = True
                break
            loop.append(cur)
            visited.add(cur)
            cur = nxt.get(cur)
        if cur is None:
            broken = True
        if not broken and len(loop) >= 3:
            loops.append(np.asarray(loop, np.int64))
    return loops


def fill_holes(
    vertices: np.ndarray,
    faces: np.ndarray,
    max_hole_edges: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fan-fill boundary loops up to ``max_hole_edges`` edges (a simplified
    ``fillHoleNicely``: centroid fan instead of refined triangulation)."""
    loops = boundary_loops(faces)
    new_vs = [vertices]
    new_fs = [faces]
    next_v = len(vertices)
    for loop in loops:
        if len(loop) > max_hole_edges:
            continue
        center = vertices[loop].mean(axis=0, keepdims=True)
        new_vs.append(center.astype(vertices.dtype))
        ring = np.stack(
            [loop, np.roll(loop, -1), np.full(len(loop), next_v)], axis=1
        )
        # Boundary edges run opposite the face winding; the fill keeps the
        # surface orientation by winding (b, a, center).
        ring = ring[:, [1, 0, 2]]
        new_fs.append(ring.astype(np.int32))
        next_v += 1
    return np.concatenate(new_vs), np.concatenate(new_fs)


def clean_repair_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    min_component_fraction: float = 0.05,
    max_hole_edges: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference clean_repair_mesh behavior: drop small components, then
    fill small holes."""
    vertices, faces = remove_small_components(
        vertices, faces, min_fraction=min_component_fraction
    )
    return fill_holes(vertices, faces, max_hole_edges=max_hole_edges)

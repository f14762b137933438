"""Iso-surface extraction via marching tetrahedra (vectorized numpy).

The port's own copy of the JAX package's ``meshing/marching.py`` (which
imports no JAX; the port imports nothing of that package), unchanged.

Fills the role of PyMCubes / Open3D ``extract_triangle_mesh`` in the
reference mesh exporters (utils/mesh.py:1250,1317,1632; SURVEY.md §2b
N5/N7).  Marching *tetrahedra* instead of marching cubes: each cell is split
into 6 tets whose 16 sign cases are derivable from first principles (no
256-entry lookup table to transcribe), at the cost of a somewhat denser
triangulation — which the downstream clean/repair + clustering pass handles
anyway.  Extraction is a one-shot offline op on active cells only
(sign-change cells, typically ~1-2% of the volume), so it runs host-side in
vectorized numpy; triangle orientation is fixed globally against the TSDF
gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Cube corner offsets, indexed 0..7.
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.int64,
)
# Six-tetrahedra decomposition of the cube (all share the 0-6 diagonal).
_TETS = np.array(
    [
        [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
        [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
    ],
    np.int64,
)
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_EDGE_ENDS = np.array(_TET_EDGES, np.int64)


def _build_case_table():
    """For each of 16 inside/outside sign cases, the triangles as triples of
    tet-edge indices; -1 padded to 2 triangles."""
    table = np.full((16, 2, 3), -1, np.int64)
    edge_idx = {e: i for i, e in enumerate(_TET_EDGES)}

    def e(a, b):
        return edge_idx[(a, b) if a < b else (b, a)]

    for case in range(16):
        inside = [bool(case >> i & 1) for i in range(4)]
        n_in = sum(inside)
        tris = []
        if n_in == 1:
            i = inside.index(True)
            o = [j for j in range(4) if j != i]
            tris = [[e(i, o[0]), e(i, o[1]), e(i, o[2])]]
        elif n_in == 3:
            i = inside.index(False)
            o = [j for j in range(4) if j != i]
            tris = [[e(i, o[0]), e(i, o[2]), e(i, o[1])]]
        elif n_in == 2:
            a, b = [j for j in range(4) if inside[j]]
            c, d = [j for j in range(4) if not inside[j]]
            tris = [
                [e(a, c), e(a, d), e(b, d)],
                [e(a, c), e(b, d), e(b, c)],
            ]
        for t, tri in enumerate(tris):
            table[case, t] = tri
    return table


_CASE_TABLE = _build_case_table()


def marching_tetrahedra(
    sdf: np.ndarray,
    level: float = 0.0,
    mask: Optional[np.ndarray] = None,
    weld_decimals: int = 6,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a [X, Y, Z] scalar field.

    Args:
        sdf: scalar field; surface at ``sdf == level``; negative = inside.
        mask: optional [X, Y, Z] bool of voxels with valid data (e.g. TSDF
            weight > 0); cells touching invalid voxels are skipped.
        weld_decimals: vertex-welding quantization.

    Returns:
        (vertices [V, 3] in voxel coordinates, faces [F, 3] int32) with
        faces wound so normals point toward positive ``sdf``.
    """
    sdf = np.asarray(sdf, np.float32)
    X, Y, Z = sdf.shape

    # Active cells: those whose 8 corners straddle the level (and are valid).
    corner_vals = np.empty((X - 1, Y - 1, Z - 1, 8), np.float32)
    for ci, (dx, dy, dz) in enumerate(_CORNERS):
        corner_vals[..., ci] = sdf[dx : X - 1 + dx, dy : Y - 1 + dy,
                                   dz : Z - 1 + dz]
    # Inside = (s < level), outside = (s >= level); a cell is active when it
    # has both.  >= on the outside test keeps surfaces that pass exactly
    # through voxel centers (s == level) extractable.
    active = (corner_vals.min(-1) < level) & (corner_vals.max(-1) >= level)
    if mask is not None:
        ok = np.ones((X - 1, Y - 1, Z - 1), bool)
        for dx, dy, dz in _CORNERS:
            ok &= mask[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]
        active &= ok
    cell_idx = np.argwhere(active)                      # [C, 3]
    if len(cell_idx) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    vals = corner_vals[active]                          # [C, 8]

    all_tris = []
    for tet in _TETS:
        tv = vals[:, tet]                               # [C, 4]
        inside = tv < level
        case = (
            inside[:, 0] * 1 + inside[:, 1] * 2
            + inside[:, 2] * 4 + inside[:, 3] * 8
        )
        tris = _CASE_TABLE[case]                        # [C, 2, 3] edge ids
        has_tri = tris[:, :, 0] >= 0                    # [C, 2]
        c_sel, t_sel = np.nonzero(has_tri)
        if len(c_sel) == 0:
            continue
        tri_edges = tris[c_sel, t_sel]                  # [M, 3]

        # Interpolate each triangle vertex along its tet edge.
        corners_pos = cell_idx[c_sel][:, None, :] + 0.0  # [M, 1, 3]
        tet_corner_pos = _CORNERS[tet]                  # [4, 3]
        verts = np.empty((len(c_sel), 3, 3), np.float32)
        for k in range(3):
            ea = _EDGE_ENDS[tri_edges[:, k], 0]
            eb = _EDGE_ENDS[tri_edges[:, k], 1]
            va = tv[c_sel, ea]
            vb = tv[c_sel, eb]
            pa = corners_pos[:, 0, :] + tet_corner_pos[ea]
            pb = corners_pos[:, 0, :] + tet_corner_pos[eb]
            # Canonicalize endpoint order by global grid position so every
            # tet sharing this edge computes a bit-identical vertex (else
            # t vs 1-t float rounding can straddle a welding bin and leave
            # hairline seams in the welded mesh).
            key_a = (pa[:, 0] * Y + pa[:, 1]) * Z + pa[:, 2]
            key_b = (pb[:, 0] * Y + pb[:, 1]) * Z + pb[:, 2]
            swap = key_a > key_b
            va2 = np.where(swap, vb, va)
            vb2 = np.where(swap, va, vb)
            pa2 = np.where(swap[:, None], pb, pa)
            pb2 = np.where(swap[:, None], pa, pb)
            t = (level - va2) / np.where(
                np.abs(vb2 - va2) < 1e-12, 1e-12, vb2 - va2
            )
            t = np.clip(t, 0.0, 1.0)[:, None]
            verts[:, k, :] = pa2 + t * (pb2 - pa2)
        all_tris.append(verts)

    soup = np.concatenate(all_tris, axis=0)             # [T, 3, 3]

    # Weld vertices.
    flat = soup.reshape(-1, 3)
    keys = np.round(flat * 10**weld_decimals).astype(np.int64)
    # The unique keys in lexicographic order, each vertex's rank among them
    # and each key's first occurrence: np.unique(keys, axis=0) with its
    # inverse and first indices, by one stable lexsort (np.unique sorts the
    # rows as a structured view, several times slower on large meshes).
    # Vertices lie inside the grid, so the keys are small and non-negative:
    # the first two pack into one int64 with their order kept.
    bits = int(keys.max()).bit_length() if len(keys) else 0
    if keys.min(initial=0) >= 0 and 2 * bits <= 62:
        order = np.lexsort((keys[:, 2], (keys[:, 0] << bits) | keys[:, 1]))
    else:
        order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    sk = keys[order]
    new = np.ones(len(sk), bool)
    new[1:] = np.any(sk[1:] != sk[:-1], axis=1)
    inv = np.empty(len(keys), np.int64)
    inv[order] = np.cumsum(new) - 1
    # Representative positions (first occurrence).
    vertices = flat[order[new]]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces.
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]

    # Orient faces against the field gradient (normals toward +sdf).
    grad = np.stack(np.gradient(sdf), axis=-1)          # [X, Y, Z, 3]
    centers = vertices[faces].mean(axis=1)
    ci = np.clip(np.round(centers).astype(np.int64), 0,
                 np.array(sdf.shape) - 1)
    g = grad[ci[:, 0], ci[:, 1], ci[:, 2]]
    n = np.cross(
        vertices[faces[:, 1]] - vertices[faces[:, 0]],
        vertices[faces[:, 2]] - vertices[faces[:, 0]],
    )
    flip = np.sum(n * g, axis=-1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return vertices.astype(np.float32), faces


def trilinear_sample(
    grid: np.ndarray, pts: np.ndarray
) -> np.ndarray:
    """Trilinearly sample a [X, Y, Z, C] grid at voxel-space points [V, 3]."""
    X, Y, Z = grid.shape[:3]
    p = np.clip(pts, 0, np.array([X - 1, Y - 1, Z - 1]) - 1e-6)
    i0 = np.floor(p).astype(np.int64)
    f = (p - i0).astype(np.float32)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                idx = np.minimum(
                    i0 + [dx, dy, dz], [X - 1, Y - 1, Z - 1]
                )
                out = out + w[:, None] * grid[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out

"""Poisson surface reconstruction on a regular grid, solved spectrally.

Counterpart of the JAX package's ``meshing/poisson.py`` (see its module
docstring for the method): splat the oriented normals into a vector grid
with trilinear weights, take its divergence by central differences, divide
by the eigenvalues of the periodic 7-point Laplacian in one real FFT
(``torch.fft.rfftn``/``irfftn`` in complex64), place the iso level at the
mean of chi over the input samples, and extract it with marching
tetrahedra on the host.

The splat is the one reduction here.  JAX scatters with eight
``grid.at[flat].add`` calls; on the card their plain equivalent,
``index_add_``, is a float atomic add whose sums land in another order on
every run, so one splat would give another mesh on every export.  Here the
eight corners' voxel ids form one id stream, corner-major and each corner's
rows in point order, and ``ops/segsum.py::segment_sum`` (a stable sort and
the sorted segment-sum kernel) sums the weighted rows: the reduction JAX's
scatter computes, in the same order, with no atomics.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.segsum import segment_sum
from ..utils.device import resolve_device
from ..utils.stages import StageTimer
from .marching import marching_tetrahedra, trilinear_sample


def scatter_rows(grid_res: int, pts: torch.Tensor, vals: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trilinear splat of [N, C] values at continuous voxel coordinates
    [N, 3] as (int32 flat voxel ids [8N], weighted rows [8N, C]): corner
    (dx, dy, dz) in x-major order, each corner's rows in point order."""
    r = grid_res
    i0 = torch.floor(pts).to(torch.int32)
    f = pts - i0
    ids, rows = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                ii = torch.clamp(i0 + torch.tensor(
                    [dx, dy, dz], dtype=torch.int32, device=pts.device),
                    0, r - 1)
                ids.append((ii[:, 0] * r + ii[:, 1]) * r + ii[:, 2])
                rows.append(w[:, None] * vals)
    return torch.cat(ids), torch.cat(rows)


def _trilinear_scatter(grid_res: int, pts: torch.Tensor, vals: torch.Tensor
                       ) -> torch.Tensor:
    """Scatter-add [N, C] values at continuous voxel coords [N, 3] into a
    [R, R, R, C] grid with trilinear weights, as one sorted segment sum."""
    r = grid_res
    ids, rows = scatter_rows(r, pts, vals)
    return segment_sum(ids, rows, r * r * r).reshape(r, r, r, -1)


def _central_diff(a: torch.Tensor, axis: int) -> torch.Tensor:
    """(a[i+1] - a[i-1]) / 2, periodic at the ends as JAX's ``roll``."""
    fwd = torch.roll(a, -1, axis)
    bwd = torch.roll(a, 1, axis)
    return 0.5 * (fwd - bwd)


def _poisson_field(
    pts_vox: torch.Tensor,
    normals: torch.Tensor,
    grid_res: int,
    screen: float,
    timer: Optional[StageTimer] = None,
) -> torch.Tensor:
    """Solve the (screened) Poisson equation; returns chi [R, R, R] on the
    device of ``pts_vox``."""
    timer = timer or StageTimer(None)
    r = grid_res
    with timer("scatter"):
        splat = _trilinear_scatter(
            r, pts_vox, torch.cat([normals, torch.ones_like(normals[:, :1])],
                                  dim=-1))
    with timer("fft solve"):
        v, rho = splat[..., :3], splat[..., 3]
        div = (_central_diff(v[..., 0], 0) + _central_diff(v[..., 1], 1)
               + _central_diff(v[..., 2], 2))
        rhs = div - screen * rho

        # Eigenvalues of the 7-point Laplacian under periodic boundary:
        # 2*(cos(2 pi k / R) - 1) summed per axis.
        dev = pts_vox.device
        k = torch.arange(r, dtype=torch.float32, device=dev)
        eig1 = 2.0 * (torch.cos(2.0 * math.pi * k / r) - 1.0)
        kz = torch.arange(r // 2 + 1, dtype=torch.float32, device=dev)
        eigz = 2.0 * (torch.cos(2.0 * math.pi * kz / r) - 1.0)
        denom = (eig1[:, None, None] + eig1[None, :, None]
                 + eigz[None, None, :] - screen)
        denom = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)

        chi_hat = torch.fft.rfftn(rhs) / denom
        if screen == 0.0:
            chi_hat[0, 0, 0] = 0.0   # fix the free constant
        chi = torch.fft.irfftn(chi_hat, s=(r, r, r))
    return chi


def voxel_coords(points: np.ndarray, grid_res: int, margin: float = 0.1
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(points in voxel coordinates, grid origin, voxel size): the cloud's
    bounding box padded by ``margin`` of its span on every side."""
    lo = points.min(0)
    hi = points.max(0)
    span = float((hi - lo).max()) or 1.0
    pad = margin * span
    origin = lo - pad
    scale = (span + 2 * pad) / (grid_res - 1)
    return (points - origin) / scale, origin, scale


def poisson_reconstruct(
    points: np.ndarray,
    normals: np.ndarray,
    grid_res: int = 256,
    margin: float = 0.1,
    screen: float = 0.0,
    colors: Optional[np.ndarray] = None,
    device=None,
    stage_times: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Reconstruct a watertight surface from an oriented point cloud.

    Args:
        points: [N, 3] world-space samples.
        normals: [N, 3] outward unit normals.
        grid_res: solve resolution R (memory is R^3 floats, 64 MB at 256).
        margin: bbox padding fraction (isolates periodic wraparound).
        screen: screening weight (0 = pure Poisson).
        colors: optional [N, 3]; when given, per-vertex colors are
            interpolated from the nearest splatted samples.
        device: where the splat and the solve run (the card by default).
        stage_times: when a dict, host seconds per stage are appended to
            it (``utils/stages.py``).

    Returns:
        (vertices [V, 3] world, faces [F, 3] int32, vertex_colors or None).
        Normals of the result point along the input normals' side (outward).
    """
    dev = resolve_device(device)
    timer = StageTimer(stage_times, dev)
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    if len(points) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                None if colors is None else np.zeros((0, 3), np.float32))
    pts_vox, origin, scale = voxel_coords(points, grid_res, margin)

    pts_t = torch.from_numpy(pts_vox).to(dev)
    chi = _poisson_field(pts_t, torch.from_numpy(normals).to(dev), grid_res,
                         float(screen), timer)
    with timer("to host"):
        chi = chi.cpu().numpy()

    with timer("marching"):
        # Iso level: mean chi over the input samples (Open3D's density
        # quantile 0 with mean-level convention).
        iso = float(np.mean(trilinear_sample(chi[..., None], pts_vox)[:, 0]))
        # chi grows along +normal across the surface: inside has chi < iso,
        # and marching_tetrahedra winds faces toward positive (chi - iso),
        # i.e. outward, matching the input orientation.
        verts, faces = marching_tetrahedra(chi, level=iso)
    verts_w = verts * scale + origin

    vcols = None
    if colors is not None and len(verts_w):
        with timer("colors"):
            cvals = np.concatenate([colors, np.ones((len(colors), 1))], -1)
            cgrid = _trilinear_scatter(
                grid_res, pts_t,
                torch.from_numpy(cvals.astype(np.float32)).to(dev),
            ).cpu().numpy()
            samp = trilinear_sample(cgrid, verts)
            vcols = samp[:, :3] / np.clip(samp[:, 3:4], 1e-6, None)
            vcols = np.clip(vcols, 0.0, 1.0)
    return verts_w.astype(np.float32), faces, vcols

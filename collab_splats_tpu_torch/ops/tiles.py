"""Tile binning: map projected Gaussians to per-tile, depth-ordered windows.

Counterpart of the JAX package's ``ops/tiles.py``.  The pipeline:

1. each Gaussian's tile bbox and intersection count, with whole Gaussians
   that would overflow the global buffer dropped and counted;
2. a depth rank per Gaussian (exact argsort ranks or quantized log-depth);
3. the run-length decode of the intersection buffer into one
   ``tile << rank_bits | rank`` sort key and a gaussian id per slot, with
   the exact ellipse-vs-tile cull (``ops/cuda/binning_kernel.py``: the
   CUDA kernel on the card, its plain version on the CPU);
4. a stable sort of the int32 keys (equal keys keep gaussian-major slot
   order, as ``jax.lax.sort`` does);
5. per-tile windows of at most ``tile_capacity`` front-most splats.

Slots that are past the buffer's live total, or culled, carry the sentinel
key ``num_tiles << rank_bits`` and gid 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.compositing import ALPHA_CUTOFF
from ..core.options import RenderOptions
from ..core.projection import Projection
from .cuda.binning_kernel import DecodeInputs, decode_bin_keys


class TileBins(NamedTuple):
    tile_gauss: torch.Tensor  # [T, K] int32 gaussian index, front-to-back
    tile_mask: torch.Tensor   # [T, K] bool validity
    num_tiles_x: int
    num_tiles_y: int
    spilled: torch.Tensor     # [] int32 dropped intersections (global + tile)
    sorted_gid: torch.Tensor  # [M] int32 gaussian ids sorted by (tile, depth)
    starts: torch.Tensor      # [T+1] int32 segment starts into sorted_gid
    # [] int64 intersections of the Gaussians the global cap dropped: with
    # starts[-1], every intersection binning was given, before any cut.
    dropped: torch.Tensor


def default_max_intersections(n: int) -> int:
    return int(min(max(8 * n, 1 << 15), 1 << 24))


def default_tile_capacity(n: int) -> int:
    cap = 1 << 9  # 512
    while cap > 8 and cap > 2 * n:
        cap //= 2
    return cap


def align_segments(bounds: torch.Tensor, sorted_gid: torch.Tensor,
                   chunk: int):
    """Re-lay the sorted intersection list so that every tile's segment
    starts on a ``chunk`` boundary (the per-tile compositor walks whole
    chunks).

    Args:
        bounds: [T+1] int32 tight segment bounds into ``sorted_gid``.
        sorted_gid: [M] int32 gaussian ids sorted by (tile, depth).
        chunk: the alignment quantum (``ops/cuda/composite.py::CHUNK``).

    Returns:
        (aligned_gid [M + T*chunk] int32, aligned_starts [T+1] int32, all
        multiples of ``chunk``, lens [T] int32 true segment lengths, valid
        [M + T*chunk] bool).  The first three are the JAX function's
        outputs: padding slots (``valid`` False) hold id 0.
    """
    num_tiles = bounds.shape[0] - 1
    m = sorted_gid.shape[0]
    dev = bounds.device
    lens = bounds[1:] - bounds[:-1]
    padded = (lens + chunk - 1) // chunk * chunk
    aligned_starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                                torch.cumsum(padded, 0).to(torch.int32)])
    slots = torch.arange(m + num_tiles * chunk, dtype=torch.int32,
                         device=dev)
    t = torch.clamp(torch.searchsorted(aligned_starts, slots, right=True)
                    - 1, 0, num_tiles - 1)
    r = slots - aligned_starts[t]
    valid = r < lens[t]
    src = torch.clamp(bounds[t] + r, 0, m - 1)
    aligned_gid = torch.where(valid, sorted_gid[src], torch.zeros_like(r))
    return aligned_gid, aligned_starts, lens, valid


def tile_bbox(proj: Projection, num_tiles_x: int, num_tiles_y: int,
              tile_size: int):
    """Inclusive int32 tile bbox (tx0, ty0, tx1, ty1) per Gaussian, from the
    per-axis half-extents ``radius_xy``, clamped to the grid."""
    u, v = proj.mean2d[:, 0], proj.mean2d[:, 1]
    rx, ry = proj.radius_xy[:, 0], proj.radius_xy[:, 1]

    def cell(x, hi):
        return torch.clamp(torch.floor(x / tile_size), 0, hi - 1).to(
            torch.int32)

    return (cell(u - rx, num_tiles_x), cell(v - ry, num_tiles_y),
            cell(u + rx, num_tiles_x), cell(v + ry, num_tiles_y))


def cull_threshold(opacities: torch.Tensor | None, n: int,
                   device) -> torch.Tensor:
    """[N] largest sigma with alpha >= ALPHA_CUTOFF: log(opac/ALPHA_CUTOFF),
    or its opacity-1 upper bound when no opacities are given."""
    if opacities is None:
        return torch.full((n,), float(-np.log(ALPHA_CUTOFF)),
                          dtype=torch.float32, device=device)
    return torch.log(torch.clamp(opacities / ALPHA_CUTOFF, min=1e-12))


class BinPlan(NamedTuple):
    """Everything the run-length decode needs, and the grid it bins into."""

    inputs: DecodeInputs
    m_cap: int             # slots of the global intersection buffer
    k_cap: int             # per-tile window length
    ntx: int
    nty: int
    rank_bits: int
    dropped: torch.Tensor  # [] int64 intersections of dropped gaussians


def plan_bins(
    proj: Projection,
    width: int,
    height: int,
    opts: RenderOptions,
    opacities: torch.Tensor | None = None,
) -> BinPlan:
    """Per-gaussian decode fields: tile bbox, run offsets with the global
    overflow guard, depth ranks and (with the ellipse cull) the cull
    columns."""
    n = proj.depth.shape[0]
    dev = proj.depth.device
    ts = opts.tile_size
    ntx = -(-width // ts)
    nty = -(-height // ts)
    num_tiles = ntx * nty
    m_cap = opts.max_intersections or default_max_intersections(n)
    k_cap = opts.tile_capacity or default_tile_capacity(n)

    tx0, ty0, tx1, ty1 = tile_bbox(proj, ntx, nty, ts)
    ncols = tx1 - tx0 + 1
    nrows = ty1 - ty0 + 1
    counts = torch.where(proj.valid, ncols * nrows,
                         torch.zeros_like(ncols)).to(torch.int64)

    # Drop whole Gaussians that would overflow the global buffer.  The raw
    # count total can exceed int32, so the first pass runs in float32 --
    # exact until the running sum passes 2^24 >= m_cap, monotone after --
    # and the exact offsets are recomputed over kept counts only, with an
    # exact guard for the boundary rows the float pass may have kept.
    approx_incl = torch.cumsum(counts.to(torch.float32), dim=0)
    keep0 = approx_incl <= float(m_cap)
    counts_kept = torch.where(keep0, counts, torch.zeros_like(counts))
    offsets = torch.cumsum(counts_kept, dim=0) - counts_kept
    keep = keep0 & (offsets + counts_kept <= m_cap)
    kept = torch.where(keep, counts, torch.zeros_like(counts))
    dropped = torch.clamp(counts.sum() - kept.sum(), max=2_000_000_000)
    counts = kept
    offsets = torch.cumsum(counts, dim=0) - counts

    # Depth ranks: exact (one stable N-argsort) or quantized log-depth.
    tile_bits = max(int(np.ceil(np.log2(num_tiles + 2))), 1)
    rank_bits = 31 - tile_bits
    if opts.exact_binning:
        inf = torch.full_like(proj.depth, float("inf"))
        order = torch.argsort(torch.where(proj.valid, proj.depth, inf),
                              stable=True)
        rank = torch.empty(n, dtype=torch.int32, device=dev)
        rank[order] = torch.arange(n, dtype=torch.int32, device=dev)
        n_bits = max(int(np.ceil(np.log2(max(n, 2)))), 1)
        if n_bits > rank_bits:
            rank = rank >> (n_bits - rank_bits)
    else:
        # Levels clamp to 2^24 - 1 on every path, as in the JAX package.
        levels = (1 << min(rank_bits, 24)) - 1
        log_d = torch.log(torch.clamp(proj.depth, opts.near_plane,
                                      opts.far_plane))
        lo = torch.log(torch.tensor(opts.near_plane, dtype=torch.float32))
        hi = torch.log(torch.tensor(min(opts.far_plane, 1e6),
                                    dtype=torch.float32))
        frac = (log_d - lo.to(dev)) / (hi - lo).to(dev)
        rank = (torch.clamp(frac, 0.0, 1.0) * levels).to(torch.int32)

    cull = None
    if opts.ellipse_cull:
        thresh = cull_threshold(opacities, n, dev)
        cull = torch.stack([proj.mean2d[:, 0], proj.mean2d[:, 1],
                            proj.conic[:, 0], proj.conic[:, 1],
                            proj.conic[:, 2], thresh], dim=1).contiguous()
    inputs = DecodeInputs(
        offsets=offsets.to(torch.int32), counts=counts.to(torch.int32),
        ncols=torch.clamp(ncols, min=1).to(torch.int32),
        tile0=(ty0 * ntx + tx0).to(torch.int32), rank=rank.to(torch.int32),
        cull=cull,
    )
    return BinPlan(inputs, m_cap, k_cap, ntx, nty, rank_bits, dropped)


def bin_gaussians(
    proj: Projection,
    width: int,
    height: int,
    opts: RenderOptions,
    opacities: torch.Tensor | None = None,
) -> TileBins:
    """Build per-tile depth-ordered Gaussian windows.

    Depth order is an integer rank fused with the tile id into one 31-bit
    key, so the M-sized sort is a single-key int32 sort with the gid as
    payload.  Ordering is exact while ``N <= 2^(31 - ceil(log2(T + 2)))``;
    beyond that neighbouring ranks may tie.
    """
    plan = plan_bins(proj, width, height, opts, opacities)
    num_tiles = plan.ntx * plan.nty
    key, gid = decode_bin_keys(plan.inputs, plan.m_cap, plan.ntx,
                               opts.tile_size, plan.rank_bits, num_tiles)
    sorted_key, order = torch.sort(key, stable=True)
    return _windows_from_sorted(sorted_key, gid[order], num_tiles,
                                plan.rank_bits, plan.ntx, plan.nty,
                                plan.k_cap, plan.m_cap, plan.dropped)


def _windows_from_sorted(sorted_key, sorted_gid, num_tiles, rank_bits,
                         ntx, nty, k_cap, m_cap, dropped) -> TileBins:
    """Per-tile capacity windows over the (tile | rank)-sorted list."""
    dev = sorted_key.device
    tile_range = torch.arange(num_tiles + 1, dtype=torch.int32,
                              device=dev) << rank_bits
    bounds = torch.searchsorted(sorted_key, tile_range, side="left").to(
        torch.int32)
    starts, ends = bounds[:-1], bounds[1:]
    win = starts[:, None] + torch.arange(k_cap, dtype=torch.int32,
                                         device=dev)[None, :]
    tile_mask = win < ends[:, None]
    tile_gauss = sorted_gid[torch.clamp(win, 0, m_cap - 1).long()]
    tile_spill = torch.clamp(ends - starts - k_cap, min=0).sum()
    return TileBins(
        tile_gauss=tile_gauss,
        tile_mask=tile_mask,
        num_tiles_x=ntx,
        num_tiles_y=nty,
        spilled=(dropped + tile_spill).to(torch.int32),
        sorted_gid=sorted_gid,
        starts=bounds,
        dropped=dropped,
    )

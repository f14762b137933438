"""Tiled rasterizer: projection -> binning -> compositing -> maps.

Counterpart of the JAX package's ``ops/rasterize.py``.  Projection and
binning are dense tensor code shared by both compositors, which
``RenderOptions.backend`` selects:

* ``"xla"`` (:func:`render_tiled`, the JAX fused-compositor branch): one
  row gather of the packed per-gaussian matrix into [T, K] tile windows
  (with a sorted segment-sum backward, ``ops/segsum.py``), then the
  batched compositor of ``ops/cuda/batched.py`` over every tile at once;
* ``"pallas"`` (:func:`render_tiled_pallas`): the sorted intersection list
  re-laid into CHUNK-aligned tile segments, then the per-tile compositor of
  ``ops/cuda/composite.py`` with its tile-wide early exit, which reads each
  slot's row of the per-gaussian matrix through the aligned ids (its
  backward sums the slots' gradient rows per gaussian by the same sorted
  segment sum).

The CUDA kernels run on the card and their plain versions on the CPU.  An
optional additive screen-space sink on the means collects the mean
gradient that densification reads: per (tile, window slot) for ``"xla"``,
per intersection for ``"pallas"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.cameras import Camera
from ..core.golden import RenderOutput
from ..core.options import RenderOptions
from ..core.projection import Projection, project_gaussians
from .cuda.batched import composite
from .cuda.composite import CHUNK, composite_tiles
from .segsum import expand_rows, spread_masked
from .tiles import (TileBins, align_segments, bin_gaussians,
                    default_max_intersections, default_tile_capacity)

# Packed per-gaussian column layout shared by every compositing path.
PG_MEAN2D = slice(0, 2)
PG_CONIC = slice(2, 5)
PG_DEPTH = 5
PG_PLANE = slice(6, 8)
PG_OPAC = 8
PG_NORMAL = slice(9, 12)
PG_COLORS = slice(12, None)
PG_FIXED = 12   # columns before the C colour/feature channels


def pack_per_gauss(proj: Projection, opac: torch.Tensor,
                   normal_cam: torch.Tensor,
                   colors: torch.Tensor) -> torch.Tensor:
    """[N, 12+C] packed per-gaussian matrix in the PG_* column layout."""
    return torch.cat(
        [proj.mean2d, proj.conic, proj.depth[:, None], proj.plane,
         opac[:, None], normal_cam, colors],
        dim=1,
    )


def window_rows(bins: TileBins, per_gauss: torch.Tensor) -> torch.Tensor:
    """[T, K, 12+C] contiguous rows of every tile window's splats: one row
    gather of the packed per-gaussian matrix.  Dead window slots gather
    spread-out rows, which the tile mask zeroes in the compositor."""
    num_tiles, k_cap = bins.tile_gauss.shape
    flat_idx = spread_masked(bins.tile_gauss.reshape(-1),
                             bins.tile_mask.reshape(-1), per_gauss.shape[0])
    return expand_rows(per_gauss, flat_idx).reshape(
        num_tiles, k_cap, per_gauss.shape[1])


def pad_per_gauss(per_gauss: torch.Tensor) -> torch.Tensor:
    """:func:`pack_per_gauss`'s matrix with zero columns up to a multiple of
    8 (the per-tile compositor's rows, as the JAX package pads them)."""
    pad = (-per_gauss.shape[1]) % 8
    return torch.nn.functional.pad(per_gauss, (0, pad)) if pad else per_gauss


def pack_intersections(proj: Projection, opac: torch.Tensor,
                       colors: torch.Tensor, normal_cam: torch.Tensor,
                       sorted_gid: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The JAX package's packed per-intersection matrix [D, M] (row layout
    in ``ops/cuda/composite.py``): the PG_* columns of each intersection's
    gaussian, padded to a multiple of 8 rows.  The per-tile compositor no
    longer takes it (it reads the rows through the ids); it stays as the
    reference the compositor's gather is held to.  The gather is
    :func:`expand_rows`, so its backward is the sorted segment sum; slots
    where ``valid`` is False (the alignment padding, id 0 in the JAX
    package) gather spread-out rows instead, which the compositor masks and
    whose cotangents are exactly 0."""
    per_gauss = pad_per_gauss(pack_per_gauss(proj, opac, normal_cam, colors))
    idx = spread_masked(sorted_gid, valid, per_gauss.shape[0])
    return expand_rows(per_gauss, idx).T.contiguous()


def absgrad_sink_shape(width: int, height: int, n: int,
                       opts: RenderOptions) -> tuple[int, int, int]:
    """Shape [T, K, 2] of the screen-space sink of a render of ``n``
    Gaussians: one (u, v) per tile window slot."""
    ts = opts.tile_size
    ntx, nty = -(-width // ts), -(-height // ts)
    k = opts.tile_capacity or default_tile_capacity(n)
    return (ntx * nty, k, 2)


def pallas_sink_shape(width: int, height: int, n: int,
                      opts: RenderOptions) -> tuple[int, int]:
    """Shape [2, M + T * CHUNK] of the per-intersection sink of a
    ``backend="pallas"`` render of ``n`` Gaussians: one (u, v) per slot of
    the aligned intersection list (:func:`~.tiles.align_segments`)."""
    m = opts.max_intersections or default_max_intersections(n)
    ts = opts.tile_size
    num_tiles = (-(-width // ts)) * (-(-height // ts))
    return (2, m + num_tiles * CHUNK)


class RenderMeta(NamedTuple):
    """Side information of a render (the gsplat ``info`` dict's content).

    ``aligned_gid`` and ``aligned_valid`` ([M + T * CHUNK]) describe the
    aligned intersection list of a ``backend="pallas"`` render: each slot's
    gaussian (0 in the padding, as in the JAX package) and whether the slot
    is a real intersection."""

    proj: Projection
    bins: TileBins
    width: int
    height: int
    aligned_gid: Optional[torch.Tensor] = None
    aligned_valid: Optional[torch.Tensor] = None


def _project(means, quats, scales, opacities, camera, opts, normals_world,
             alive_mask):
    """(projection, compositing opacity, camera-space normals) of a
    render."""
    viewmat = camera.viewmat()
    proj = project_gaussians(
        means, quats, scales, viewmat, camera.K, camera.width, camera.height,
        eps2d=opts.eps2d, near_plane=opts.near_plane,
        far_plane=opts.far_plane, radius_clip=opts.radius_clip,
        opacities=opacities,
    )
    if alive_mask is not None:
        proj = proj._replace(valid=proj.valid & alive_mask)
    opac = opacities
    if opts.rasterize_mode == "antialiased":
        opac = opac * proj.compensation
    if normals_world is not None:
        normal_cam = normals_world @ viewmat[:3, :3].T
    else:
        normal_cam = proj.normal
    return proj, opac, normal_cam


def render_tiled(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    camera: Camera,
    opts: RenderOptions = RenderOptions(),
    normals_world: Optional[torch.Tensor] = None,
    absgrad_sink: Optional[torch.Tensor] = None,
    alive_mask: Optional[torch.Tensor] = None,
) -> tuple[RenderOutput, RenderMeta]:
    """Render one camera with the tiled rasterizer's batched compositor.

    ``colors`` is [N, C] with SH already evaluated; ``alive_mask`` ([N]
    bool) removes dead capacity-padding rows from binning; ``absgrad_sink``
    (zeros of :func:`absgrad_sink_shape`) is added to the window rows'
    2D means, so its gradient is the per-(tile, slot) mean gradient.
    Returns (RenderOutput with [H, W, ...] maps and no background,
    RenderMeta).
    """
    proj, opac, normal_cam = _project(means, quats, scales, opacities,
                                      camera, opts, normals_world,
                                      alive_mask)
    return render_from_projections(proj, opac, colors, normal_cam, camera,
                                   opts, absgrad_sink=absgrad_sink)


def render_tiled_pallas(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    camera: Camera,
    opts: RenderOptions = RenderOptions(),
    normals_world: Optional[torch.Tensor] = None,
    absgrad_sink: Optional[torch.Tensor] = None,
    alive_mask: Optional[torch.Tensor] = None,
) -> tuple[RenderOutput, RenderMeta]:
    """Render one camera with the per-tile compositor.

    Same contract as :func:`render_tiled`, except that ``absgrad_sink`` is
    per intersection: zeros of :func:`pallas_sink_shape`, added to each
    slot's 2D mean as the compositor reads it, so its gradient is the
    per-(tile, splat) mean gradient
    (``train/strategy.py::update_state_from_isect`` reads it).
    A tile ends once every pixel's transmittance is below
    ``opts.stop_threshold`` (0: never early).
    """
    proj, opac, normal_cam = _project(means, quats, scales, opacities,
                                      camera, opts, normals_world,
                                      alive_mask)
    # The [T, K] windows are not composited on this path; binning still
    # builds them, and their spill count is replaced below.
    bins = bin_gaussians(proj, camera.width, camera.height, opts,
                         opacities=opac.detach())
    ts = opts.tile_size
    n_color = colors.shape[-1]
    aligned_gid, aligned_starts, lens, valid = align_segments(
        bins.starts, bins.sorted_gid, CHUNK)
    per_gauss = pad_per_gauss(pack_per_gauss(proj, opac, normal_cam, colors))
    k_cap = opts.tile_capacity or default_tile_capacity(means.shape[0])
    max_chunks = max(-(-k_cap // CHUNK), 1)
    packed = composite_tiles(per_gauss, aligned_gid, valid, aligned_starts,
                             lens, bins.num_tiles_x, ts, n_color,
                             opts.near_plane, opts.stop_threshold,
                             max_chunks, sink=absgrad_sink)
    color = packed[..., :n_color]
    normal = packed[..., n_color:n_color + 3]
    alpha = packed[..., n_color + 3]
    depth_sum = packed[..., n_color + 4]
    median = packed[..., n_color + 5]
    if opts.normalize_depth:
        depth = depth_sum / torch.clamp(alpha, min=1e-10)
    else:
        depth = depth_sum
    out, meta = _stitch_outputs(color, alpha, depth, median, normal, bins,
                                proj, camera, ts)
    # bins.spilled counts what the K-slot windows cut; this compositor cuts
    # at max_chunks * CHUNK (>= K) instead, so that term is swapped for the
    # compositor's own.
    tile_spill = torch.clamp(lens - k_cap, min=0).sum()
    kernel_spill = torch.clamp(lens - max_chunks * CHUNK, min=0).sum() \
        - tile_spill
    out = out._replace(spilled=bins.spilled + kernel_spill.to(torch.int32))
    meta = meta._replace(aligned_gid=aligned_gid, aligned_valid=valid)
    return out, meta


def render_tiled_batch(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    cameras: Camera,
    opts: RenderOptions = RenderOptions(),
) -> RenderOutput:
    """Render a batch of cameras in one call.

    ``cameras`` is a stacked :class:`Camera` (K [B, 3, 3], c2w [B, 4, 4],
    one width and height; ``core/cameras.py::stack_cameras``).  The
    cameras render one after another with :func:`render_tiled`, as the JAX
    package's ``lax.map`` runs them: one 720p camera already fills the
    card, and the window rows of B cameras at once would scale memory with
    B.  Returns the RenderOutput fields stacked along a leading [B] axis.
    """
    outs = []
    for K, c2w in zip(cameras.K, cameras.c2w):
        cam = Camera(K=K, c2w=c2w, width=cameras.width,
                     height=cameras.height)
        outs.append(render_tiled(means, quats, scales, opacities, colors,
                                 cam, opts)[0])
    return RenderOutput(*(torch.stack(field) for field in zip(*outs)))


def render_from_projections(
    proj: Projection,
    opac: torch.Tensor,
    colors: Optional[torch.Tensor],
    normal_cam: Optional[torch.Tensor],
    camera: Camera,
    opts: RenderOptions = RenderOptions(),
    absgrad_sink: Optional[torch.Tensor] = None,
    per_gauss: Optional[torch.Tensor] = None,
) -> tuple[RenderOutput, RenderMeta]:
    """Binning + compositing from already-projected Gaussians.

    ``per_gauss`` optionally supplies the packed [N, 12+C] per-gaussian
    matrix (:func:`pack_per_gauss`'s layout); then ``proj`` and ``opac``
    feed only the binning, and ``colors`` and ``normal_cam`` are not
    read.  The sharded training step (``parallel/train.py``) composites
    a matrix gathered across devices this way.
    """
    bins = bin_gaussians(proj, camera.width, camera.height, opts,
                         opacities=opac.detach())
    ts = opts.tile_size
    if per_gauss is None:
        per_gauss = pack_per_gauss(proj, opac, normal_cam, colors)
    g_full = window_rows(bins, per_gauss)
    if absgrad_sink is not None:
        g_full = torch.cat([g_full[..., :2] + absgrad_sink, g_full[..., 2:]],
                           dim=-1)
    out_v, alpha, depth_acc, median, _ = composite(
        g_full, bins.tile_mask.to(torch.float32), bins.num_tiles_x, ts,
        opts.near_plane)
    # out_v channel order follows g's value columns: normal ++ colours.
    normal = out_v[..., :3]
    color = out_v[..., 3:]
    if opts.normalize_depth:
        depth = depth_acc / torch.clamp(alpha, min=1e-10)
    else:
        depth = depth_acc
    return _stitch_outputs(color, alpha, depth, median, normal, bins, proj,
                           camera, ts)


def _stitch_outputs(color, alpha, depth, median, normal, bins: TileBins,
                    proj: Projection, camera: Camera, ts: int):
    """Reassemble [T, P, ...] tile maps into [H, W, ...] images, cropped to
    the camera size (the tile grid overhangs sizes not divisible by ts)."""
    ntx, nty = bins.num_tiles_x, bins.num_tiles_y

    def stitch(x):
        ch = x.shape[2:]
        x = x.reshape((nty, ntx, ts, ts) + ch).transpose(1, 2)
        x = x.reshape((nty * ts, ntx * ts) + ch)
        return x[: camera.height, : camera.width]

    out = RenderOutput(
        color=stitch(color),
        alpha=stitch(alpha),
        depth=stitch(depth),
        median_depth=stitch(median),
        normal=stitch(normal),
        spilled=bins.spilled,
    )
    meta = RenderMeta(proj=proj, bins=bins, width=camera.width,
                      height=camera.height)
    return out, meta

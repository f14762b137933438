"""Tiled rasterizer: projection -> binning -> compositing -> maps.

Counterpart of the JAX package's ``ops/rasterize.py`` (its fused-compositor
branch).  Projection and binning are dense tensor code; the window gather
is one row gather of the packed per-gaussian matrix (with a sorted
segment-sum backward, ``ops/segsum.py``); compositing is the batched
compositor of ``ops/cuda/batched.py`` (the CUDA kernels on the card, the
plain versions on the CPU) over every tile at once, forward and backward.
An optional additive screen-space sink on the window rows' means collects
the per-(tile, slot) mean gradient that densification reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.cameras import Camera
from ..core.golden import RenderOutput
from ..core.options import RenderOptions
from ..core.projection import Projection, project_gaussians
from .cuda.batched import composite
from .segsum import expand_rows, spread_masked
from .tiles import TileBins, bin_gaussians, default_tile_capacity

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


def absgrad_sink_shape(width: int, height: int, n: int,
                       opts: RenderOptions) -> tuple[int, int, int]:
    """Shape [T, K, 2] of the screen-space sink of a render of ``n``
    Gaussians: one (u, v) per tile window slot."""
    ts = opts.tile_size
    ntx, nty = -(-width // ts), -(-height // ts)
    k = opts.tile_capacity or default_tile_capacity(n)
    return (ntx * nty, k, 2)


class RenderMeta(NamedTuple):
    """Side information of a render (the gsplat ``info`` dict's content)."""

    proj: Projection
    bins: TileBins
    width: int
    height: int


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
    """Render one camera with the tiled rasterizer.

    ``colors`` is [N, C] with SH already evaluated; ``alive_mask`` ([N]
    bool) removes dead capacity-padding rows from binning; ``absgrad_sink``
    (zeros of :func:`absgrad_sink_shape`) is added to the window rows'
    2D means, so its gradient is the per-(tile, slot) mean gradient.
    Returns (RenderOutput with [H, W, ...] maps and no background,
    RenderMeta).
    """
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
    return render_from_projections(proj, opac, colors, normal_cam, camera,
                                   opts, absgrad_sink=absgrad_sink)


def render_from_projections(
    proj: Projection,
    opac: torch.Tensor,
    colors: torch.Tensor,
    normal_cam: torch.Tensor,
    camera: Camera,
    opts: RenderOptions = RenderOptions(),
    absgrad_sink: Optional[torch.Tensor] = None,
) -> tuple[RenderOutput, RenderMeta]:
    """Binning + compositing from already-projected Gaussians."""
    bins = bin_gaussians(proj, camera.width, camera.height, opts,
                         opacities=opac.detach())
    ts = opts.tile_size
    g_full = window_rows(bins, pack_per_gauss(proj, opac, normal_cam, colors))
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

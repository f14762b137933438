"""Tile-sharded rendering: gaussian -> tile-band all-to-all routing.

Counterpart of the JAX package's ``parallel/tiles.py``.  In the default
sharded step (``parallel/train.py``) every process all-gathers the whole
projected set, so its memory and compositing work stay O(C) however many
processes share the ``gauss`` axis.  Here the image's tile grid is split
into G horizontal bands, one per ``gauss`` member, and the projected rows
are routed instead:

1. each member projects its C/G shard;
2. for every band it packs the ``send_cap`` nearest of its Gaussians whose
   screen box overlaps the band into a send slab, in index order;
3. one all-to-all over ``gauss`` delivers to each member exactly the
   Gaussians touching its band: buffers of O(C/G + G * send_cap) rows;
4. each member bins and composites its band (``render_from_projections``
   on a band-height camera);
5. the bands' pixel maps are all-gathered, so the loss (the windowed SSIM
   needs context across bands) sees the whole image on every member.

Backward: the all-to-all transposes to the reverse all-to-all and the band
all-gather to a reduce-scatter (``parallel/collectives.py``); the slab's
row gather is ``ops/segsum.py::expand_rows``, whose backward is the sorted
segment sum (a Gaussian overlapping two bands sends two rows, and their
gradients add without float atomics).  Per-band overflow drops the
farthest Gaussians, counted in ``spilled``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.cameras import Camera
from ..core.options import RenderOptions
from ..core.projection import Projection
from ..ops.rasterize import render_from_projections
from ..ops.segsum import expand_rows
from .collectives import all_gather_rows, all_reduce, all_to_all_rows
from .mesh import GAUSS_AXIS, Mesh


def band_rows(height: int, tile_size: int, n_bands: int) -> int:
    """Tile rows per band (the padded tile grid must split evenly)."""
    nty = -(-height // tile_size)
    if nty % n_bands:
        raise ValueError(f"tile rows {nty} do not split into {n_bands} "
                         "bands; pad the image")
    return nty // n_bands


class RouteInfo(NamedTuple):
    """Send-side slab layout of one :func:`route_to_bands` call: received
    slab row ``band * send_cap + slot`` on band owner ``band`` came from
    local Gaussian ``slot_gid[band, slot]`` of this member (where
    ``slot_valid``).  The tile-sharded step routes statistics back with
    it."""

    slot_gid: torch.Tensor    # [n_bands, send_cap] int64 local index
    slot_valid: torch.Tensor  # [n_bands, send_cap] bool


def route_to_bands(
    proj: Projection,
    extras: torch.Tensor,
    height: int,
    tile_size: int,
    mesh: Mesh,
    send_cap: int,
) -> Tuple[Projection, torch.Tensor, torch.Tensor, torch.Tensor, RouteInfo]:
    """Route this member's projections [n_local] and ``extras`` [n_local,
    E] (opacity, colours, normals: whatever the band render composites)
    to the band owners, at most ``send_cap`` rows per band.

    Returns (the received projections [G * send_cap] with band-local v,
    the received extras [G * send_cap, E], their validity [G * send_cap],
    the routing spill summed over ``gauss``, :class:`RouteInfo`).
    """
    n_bands = mesh.n_gauss
    group = mesh.group(GAUSS_AXIS)
    band_px = band_rows(height, tile_size, n_bands) * tile_size
    n = proj.depth.shape[0]
    dev = proj.depth.device

    # Band overlap from the per-axis vertical extent (ops/tiles.tile_bbox).
    v = proj.mean2d[:, 1].detach()
    r = proj.radius_xy[:, 1].detach()
    b0 = torch.clamp(torch.floor((v - r) / band_px), 0, n_bands - 1)
    b1 = torch.clamp(torch.floor((v + r) / band_px), 0, n_bands - 1)

    flat = torch.cat([
        proj.mean2d, proj.depth[:, None], proj.conic, proj.radius[:, None],
        proj.compensation[:, None], proj.plane, proj.radius_xy, extras,
    ], dim=1)
    d = flat.shape[1]
    band_ids = torch.arange(n_bands, dtype=b0.dtype, device=dev)
    member = (proj.valid[None, :] & (b0[None, :] <= band_ids[:, None])
              & (b1[None, :] >= band_ids[:, None]))          # [G, n]
    # The capacity cut keeps the nearest rows (a stable argsort, as
    # jnp.argsort); the kept rows then ride in index order, so that a band
    # owner receives them in the global gaussian order (member by member,
    # each shard in order) and bins them as the all-gather render does:
    # the same global-buffer overflow guard and tie order whenever every
    # member fits.  JAX's slab keeps the depth order instead.
    inf = torch.full_like(proj.depth, float("inf")).detach()
    order = torch.argsort(torch.where(member, proj.depth.detach()[None, :],
                                      inf[None, :]), dim=1, stable=True)
    take = min(send_cap, n)
    slot_gid = torch.sort(order[:, :take], dim=1).values
    slot_valid = torch.gather(member, 1, slot_gid)
    if send_cap > take:                     # the slab outgrows the shard
        pad = send_cap - take
        slot_gid = torch.nn.functional.pad(slot_gid, (0, pad))
        slot_valid = torch.nn.functional.pad(slot_valid, (0, pad))
    send = expand_rows(flat, slot_gid.reshape(-1).to(torch.int32))
    # Validity rides as the last channel of the same slab: one all-to-all.
    send = torch.cat([send, slot_valid.reshape(-1, 1).to(send.dtype)], dim=1)
    spilled = (member.sum() - slot_valid.sum()).to(torch.int32)

    recv = all_to_all_rows(send, group)                      # [G*S, D+1]
    valid_recv = recv[:, d] > 0.5
    spilled = all_reduce(spilled, group)

    v_off = float(mesh.gauss_idx * band_px)
    mean2d = recv[:, 0:2] - torch.tensor([0.0, v_off], dtype=recv.dtype,
                                         device=dev)
    proj_recv = Projection(
        mean2d=mean2d,
        depth=recv[:, 2],
        conic=recv[:, 3:6],
        radius=recv[:, 6],
        compensation=recv[:, 7],
        plane=recv[:, 8:10],
        normal=torch.zeros((recv.shape[0], 3), dtype=recv.dtype, device=dev),
        valid=valid_recv,
        radius_xy=recv[:, 10:12],
    )
    return proj_recv, recv[:, 12:d], valid_recv, spilled, RouteInfo(
        slot_gid=slot_gid, slot_valid=slot_valid)


def render_tile_sharded(
    proj: Projection,
    opac: torch.Tensor,
    colors: torch.Tensor,
    camera: Camera,
    opts: RenderOptions,
    mesh: Mesh,
    send_cap: int,
    normal_cam: Optional[torch.Tensor] = None,
    absgrad_sink: Optional[torch.Tensor] = None,
):
    """Whole-image render from this member's projected shard, with routed
    band-local compositing.  Returns (the RenderOutput with whole-image
    maps, the same on every ``gauss`` member; the band's RenderMeta; the
    :class:`RouteInfo`).

    ``absgrad_sink`` is the band render's sink, shaped
    ``absgrad_sink_shape(width, band_px, n_bands * send_cap, opts)``; its
    gradient indexes the received slab through ``meta.bins.tile_gauss``.
    The tile grid of ``camera.height`` must split into the ``gauss``
    axis's bands.
    """
    ts = opts.tile_size
    n_bands = mesh.n_gauss
    band_px = band_rows(camera.height, ts, n_bands) * ts
    if normal_cam is None:
        normal_cam = proj.normal
    extras = torch.cat([opac[:, None], colors, normal_cam], dim=1)
    proj_b, extras_b, valid_b, spilled, route = route_to_bands(
        proj, extras, camera.height, ts, mesh, send_cap)
    c_dim = colors.shape[1]
    opac_b = torch.where(valid_b, extras_b[:, 0],
                         torch.zeros_like(extras_b[:, 0]))
    colors_b = extras_b[:, 1:1 + c_dim]
    normal_b = extras_b[:, 1 + c_dim:4 + c_dim]

    band_cam = Camera(K=camera.K, c2w=camera.c2w, width=camera.width,
                      height=band_px)
    out, meta = render_from_projections(proj_b, opac_b, colors_b, normal_b,
                                        band_cam, opts,
                                        absgrad_sink=absgrad_sink)

    # The pixel bands, stitched on every member (backward: reduce-scatter).
    group = mesh.group(GAUSS_AXIS)

    def gather(x):
        return all_gather_rows(x, group)[:camera.height]

    full = out._replace(
        color=gather(out.color),
        alpha=gather(out.alpha),
        depth=gather(out.depth),
        median_depth=gather(out.median_depth),
        normal=gather(out.normal),
        spilled=all_reduce(out.spilled, group) + spilled,
    )
    return full, meta, route

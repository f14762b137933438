"""Golden reference renderer: exact, naive O(N * pixels) compositing.

Counterpart of the JAX package's ``core/golden.py``: every Gaussian is
evaluated at every pixel (under the same tile-membership and alpha cutoffs
as the tiled renderer, so the two agree up to per-tile capacity truncation
and float associativity).  Plain PyTorch with no kernel, differentiable,
on the device of its inputs.  It is the oracle that the tiled renderers
are held against (tests, ``chip_smoke.py``); it never runs in training.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cameras import Camera
from .compositing import composite, splat_alpha
from .options import RenderOptions
from .projection import project_gaussians

# Elements of one [rows, W, N] block of the per-pixel evaluation.
CHUNK_ELEMENTS = 1 << 22


class RenderOutput(NamedTuple):
    """Rendered maps, mirroring the reference's rasterization 6-tuple."""

    color: torch.Tensor         # [H, W, C]
    alpha: torch.Tensor         # [H, W]
    depth: torch.Tensor         # [H, W] expected depth
    median_depth: torch.Tensor  # [H, W]
    normal: torch.Tensor        # [H, W, 3] camera-space
    spilled: torch.Tensor       # [] int32: splats dropped by capacity limits


def render_golden(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    normals_world: Optional[torch.Tensor],
    camera: Camera,
    opts: RenderOptions = RenderOptions(),
) -> RenderOutput:
    """Render one camera naively.

    ``means`` [N, 3], ``quats`` [N, 4] wxyz, ``scales`` [N, 3] linear,
    ``opacities`` [N] activated, ``colors`` [N, C] (SH evaluated);
    ``normals_world`` optionally replaces the RaDe plane normals with
    world-space ones.  Returns a :class:`RenderOutput` with no background.
    """
    viewmat = camera.viewmat()
    proj = project_gaussians(
        means, quats, scales, viewmat, camera.K, camera.width, camera.height,
        eps2d=opts.eps2d, near_plane=opts.near_plane,
        far_plane=opts.far_plane, radius_clip=opts.radius_clip,
    )
    opac = opacities
    if opts.rasterize_mode == "antialiased":
        opac = opac * proj.compensation
    normal_cam = proj.normal if normals_world is None \
        else normals_world @ viewmat[:3, :3].T
    # One global depth order (stable, as jnp.argsort is).
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depth, inf),
                          stable=True)
    mean2d, conic, depth = proj.mean2d[order], proj.conic[order], \
        proj.depth[order]
    plane, radius, valid = proj.plane[order], proj.radius[order], \
        proj.valid[order]
    opac, cols, norms = opac[order], colors[order], normal_cam[order]

    # Tile bbox from the max-eigenvalue square radius: a superset of the
    # tiled renderer's per-axis boxes whose extra tiles add exactly zero.
    ts = opts.tile_size
    tx0 = torch.floor((mean2d[:, 0] - radius) / ts)
    ty0 = torch.floor((mean2d[:, 1] - radius) / ts)
    tx1 = torch.floor((mean2d[:, 0] + radius) / ts)
    ty1 = torch.floor((mean2d[:, 1] + radius) / ts)

    h, w, n = camera.height, camera.width, means.shape[0]
    dev = means.device
    u = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    v = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    rows = max(1, min(h, CHUNK_ELEMENTS // max(w * n, 1) + 1))
    ptx = torch.floor(u / ts)[None, :, None]
    maps = []
    for row0 in range(0, h, rows):
        vs = v[row0:row0 + rows]
        r = vs.shape[0]
        du = (u[None, :, None] - mean2d[None, None, :, 0]).expand(r, w, n)
        dv = (vs[:, None, None] - mean2d[None, None, :, 1]).expand(r, w, n)
        pty = torch.floor(vs / ts)[:, None, None]
        member = ((ptx >= tx0) & (ptx <= tx1) & (pty >= ty0) & (pty <= ty1))
        mask = member & valid
        alphas = splat_alpha(du, dv, conic.expand(r, w, n, 3),
                             opac.expand(r, w, n), mask)
        t_pix = torch.clamp(depth + plane[:, 0] * du + plane[:, 1] * dv,
                            min=opts.near_plane)
        out = composite(alphas, t_pix, cols.expand(r, w, *cols.shape),
                        norms.expand(r, w, *norms.shape),
                        normalize_depth=opts.normalize_depth)
        maps.append((out.color, out.alpha, out.depth, out.median_depth,
                     out.normal))
    color, alpha, depth_im, median, normal = (torch.cat(m, dim=0)
                                              for m in zip(*maps))
    return RenderOutput(color=color, alpha=alpha, depth=depth_im,
                        median_depth=median, normal=normal,
                        spilled=torch.zeros((), dtype=torch.int32,
                                            device=dev))

"""Depth-ordered alpha compositing: the plain version of the compositor.

Counterpart of the JAX package's ``core/compositing.py``.  This slice ports
the forward of the fused compositor (``_fused_fwd_common`` +
``_fused_outputs``): for every (tile, pixel) and every slot of the tile's
front-to-back window it evaluates the splat's alpha, the transmittance in
front of it, its compositing weight, and reduces the value channels, the
expected depth and the median depth.

:func:`fused_forward` is the plain PyTorch version of the CUDA kernel in
``csrc/batched_fwd.cu`` (wrapper ``ops/cuda/batched.py``).  It runs dense
[tiles, 256, K] tensors, chunked over tiles so memory stays bounded, except
for the log-transmittance scan, which runs slot by slot: its float32 sums
then round exactly as the kernel's running carry does, so the median
selection (the first slot whose accumulated opacity crosses 1/2) agrees
with the kernel bit for bit.
"""

from __future__ import annotations

import torch

# Per-splat alpha handling, matching gsplat's rasterizer.
ALPHA_CUTOFF = 1.0 / 255.0   # contributions below this are skipped
ALPHA_MAX = 0.999            # per-splat alpha is clamped to this
LOG_HALF = -0.6931471805599453

# Column layout of the gathered per-splat rows g (== ops.rasterize PG_*):
#   0 u, 1 v | 2 a, 3 b, 4 c (conic) | 5 depth | 6, 7 plane | 8 opacity |
#   9.. values (normal ++ colours).
G_VALS = 9


def splat_alpha(du: torch.Tensor, dv: torch.Tensor, conic: torch.Tensor,
                opacity: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-splat, per-pixel alpha in [0, ALPHA_MAX].

    ``du``/``dv`` [..., L] pixel offsets from the splat centre, ``conic``
    [..., L, 3], ``opacity`` [..., L] (compensated in antialiased mode),
    ``mask`` [..., L] bool.  Exactly zero where masked, below ALPHA_CUTOFF,
    or where the quadratic form is negative.
    """
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    sigma = 0.5 * (a * du * du + c * dv * dv) + b * du * dv
    alpha = opacity * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    keep = mask & (alpha >= ALPHA_CUTOFF) & (sigma >= 0.0)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def pixel_centers(tile_ids: torch.Tensor, ntx: int, ts: int):
    """Pixel-centre coordinates (up, vp), each [T, ts*ts], of the given
    tiles; pixel p of a tile is row p // ts, column p % ts."""
    p = torch.arange(ts * ts, device=tile_ids.device)
    up = (tile_ids % ntx)[:, None] * ts + (p % ts)[None, :]
    vp = (tile_ids // ntx)[:, None] * ts + (p // ts)[None, :]
    return up.to(torch.float32) + 0.5, vp.to(torch.float32) + 0.5


def _fused_chunk(g, msk, up, vp, near_plane):
    k = g.shape[1]
    du = up[:, :, None] - g[:, None, :, 0]                      # [T, P, K]
    dv = vp[:, :, None] - g[:, None, :, 1]
    a = g[:, None, :, 2]
    b = g[:, None, :, 3]
    c = g[:, None, :, 4]
    sigma = 0.5 * (a * du * du + c * dv * dv) + b * du * dv
    alpha = g[:, None, :, 8] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    keep = (msk[:, None, :] > 0) & (alpha >= ALPHA_CUTOFF) & (sigma >= 0.0)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)

    # Exclusive log-transmittance, accumulated front to back one slot at a
    # time (see the module docstring); cum_incl[k] = carry after slot k.
    cum_excl = torch.empty_like(log1m)
    cum_incl = torch.empty_like(log1m)
    carry = torch.zeros_like(log1m[..., 0])
    for j in range(k):
        cum_excl[..., j] = carry
        carry = carry + log1m[..., j]
        cum_incl[..., j] = carry
    w = alpha * torch.exp(cum_excl)
    tpix = torch.clamp(
        g[:, None, :, 5] + g[:, None, :, 6] * du + g[:, None, :, 7] * dv,
        min=near_plane,
    )

    out_v = torch.einsum("tpk,tkv->tpv", w, g[..., G_VALS:])
    alpha_out = 1.0 - torch.exp(carry)
    depth_acc = torch.sum(w * tpix, dim=-1)
    # Median: first live slot where the accumulated opacity crosses 1/2,
    # else the first max-weight slot -- one first-max over a single key.
    crossed = (cum_incl <= LOG_HALF) & (alpha > 0.0)
    kk = torch.arange(k, device=g.device)
    rank_key = 2.0 + (k - kk).to(torch.float32) / k
    med_key = torch.where(crossed, rank_key, w)
    idx = torch.argmax(med_key, dim=-1)
    median = torch.gather(tpix, -1, idx[..., None])[..., 0]
    median = torch.where(alpha_out > 0.0, median, torch.zeros_like(median))
    return out_v, alpha_out, depth_acc, median, idx.to(torch.int32)


def fused_forward(g: torch.Tensor, mask: torch.Tensor, ntx: int, ts: int,
                  near_plane: float, tile_chunk: int = 64):
    """Composite every tile's window front to back (plain version).

    Args:
        g: [T, K, 9 + V] float32 gathered per-splat rows in the ``G_VALS``
            column layout, front to back along K.
        mask: [T, K] float32, 1.0 for live window slots, 0.0 for dead ones.
        ntx: tiles per image row; tile t covers column t % ntx, row t // ntx.
        ts: tile size in pixels (P = ts * ts pixels per tile).
        near_plane: lower clamp of the per-pixel splat depth.
        tile_chunk: tiles per dense chunk.

    Returns:
        (out_v [T, P, V], alpha [T, P], depth_acc [T, P], median [T, P],
        med_idx [T, P] int32): the composited value channels, the
        accumulated opacity, the unnormalized expected depth, the median
        depth (0 where alpha is 0) and the window slot it came from.
    """
    t = g.shape[0]
    tile_ids = torch.arange(t, device=g.device)
    up, vp = pixel_centers(tile_ids, ntx, ts)
    parts = [
        _fused_chunk(g[s:s + tile_chunk], mask[s:s + tile_chunk],
                     up[s:s + tile_chunk], vp[s:s + tile_chunk], near_plane)
        for s in range(0, t, tile_chunk)
    ]
    return tuple(torch.cat(xs, dim=0) for xs in zip(*parts))

"""Depth-ordered alpha compositing: the plain version of the compositor.

Counterpart of the JAX package's ``core/compositing.py``: the fused
compositor (``_fused_fwd_common`` + ``_fused_outputs``) and its analytic
backward (``fused_bwd_from_g`` + ``moments_to_dg``).  For every (tile,
pixel) and every slot of the tile's front-to-back window the forward
evaluates the splat's alpha, the transmittance in front of it, its
compositing weight, and reduces the value channels, the expected depth and
the median depth; the backward walks the same chain back to front and
reduces the pixel cotangents to one gradient row per (tile, slot).

:func:`fused_forward` and :func:`fused_backward` are the plain PyTorch
versions of the CUDA kernels in ``csrc/batched_fwd.cu`` and
``csrc/batched_bwd.cu`` (wrapper ``ops/cuda/batched.py``).  They run dense
[tiles, 256, K] tensors, chunked over tiles so memory stays bounded, except
for the log-transmittance scan, which runs slot by slot: its float32 sums
then round exactly as the kernels' running carry does, so the median
selection (the first slot whose accumulated opacity crosses 1/2) agrees
with the kernel bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Per-splat alpha handling, matching gsplat's rasterizer.
ALPHA_CUTOFF = 1.0 / 255.0   # contributions below this are skipped
ALPHA_MAX = 0.999            # per-splat alpha is clamped to this
LOG_HALF = -0.6931471805599453
# Slots per batch of the compositing kernels; the forward banks its
# log-transmittance carry in front of every batch for the backward.
PREFIX_BATCH = 64

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


class CompositeOutput(NamedTuple):
    color: torch.Tensor         # [..., C]
    alpha: torch.Tensor         # [...]
    depth: torch.Tensor         # [...] expected depth
    median_depth: torch.Tensor  # [...]
    normal: torch.Tensor        # [..., 3]
    weights: torch.Tensor       # [..., L] per-splat compositing weights


def transmittance_weights(alphas: torch.Tensor) -> torch.Tensor:
    """Front-to-back weights ``w_k = alpha_k * prod_{j<k} (1 - alpha_j)``
    along the last axis (an exclusive cumulative product)."""
    t_incl = torch.cumprod(1.0 - alphas, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]],
                       dim=-1)
    return alphas * t_excl


def median_select(weights: torch.Tensor,
                  depth_per_pixel: torch.Tensor) -> torch.Tensor:
    """Depth of the first splat whose accumulated weight reaches 1/2, or of
    the heaviest splat where none does.  The selection is not
    differentiated; the depth gradient flows through the selected splat."""
    crossed = torch.cumsum(weights, dim=-1) >= 0.5
    # argmax returns the first maximal index: the first crossing.
    cross_idx = torch.argmax(crossed.to(torch.uint8), dim=-1)
    fallback_idx = torch.argmax(weights, dim=-1)
    idx = torch.where(crossed.any(dim=-1), cross_idx, fallback_idx).detach()
    return torch.gather(depth_per_pixel, -1, idx[..., None])[..., 0]


def composite(alphas: torch.Tensor, depth_per_pixel: torch.Tensor,
              colors: torch.Tensor, normals: torch.Tensor,
              normalize_depth: bool = True) -> CompositeOutput:
    """Front-to-back composite along the trailing splat axis L, dense: the
    naive renderer's compositor (``core/golden.py``).

    ``alphas`` and ``depth_per_pixel`` are [..., L] (front to back),
    ``colors`` [..., L, C] and ``normals`` [..., L, 3].  The expected depth
    is divided by the accumulated alpha when ``normalize_depth``; the
    median depth is 0 where nothing was hit.
    """
    weights = transmittance_weights(alphas)
    # 1 - prod(1 - a) equals sum(weights) but cannot round above 1.
    alpha_out = 1.0 - torch.prod(1.0 - alphas, dim=-1)
    color_out = torch.sum(weights[..., None] * colors, dim=-2)
    normal_out = torch.sum(weights[..., None] * normals, dim=-2)
    depth_acc = torch.sum(weights * depth_per_pixel, dim=-1)
    depth_out = depth_acc / torch.clamp(alpha_out, min=1e-10) \
        if normalize_depth else depth_acc
    median = median_select(weights, depth_per_pixel)
    median = torch.where(alpha_out > 0.0, median, torch.zeros_like(median))
    return CompositeOutput(color=color_out, alpha=alpha_out, depth=depth_out,
                           median_depth=median, normal=normal_out,
                           weights=weights)


# Added to ln(255 opacity) by :func:`sigma_cut`: far more than the float32
# rounding of the log, of exp and of the product opacity * exp(-sigma)
# (together below 2e-5 in sigma), so the cull never drops a live pair.
SIGMA_CUT_MARGIN = 1e-4
SIGMA_CLAMP = 50.0   # splat_alpha clamps sigma to [0, SIGMA_CLAMP]


def sigma_cut(opacity: torch.Tensor) -> torch.Tensor:
    """The exact cull of the compositing kernels, in float32: a pair whose
    quadratic form sigma exceeds ``sigma_cut(opacity)`` has alpha below
    ALPHA_CUTOFF, so the kernels skip its exp.

    ln(255 opacity) + SIGMA_CUT_MARGIN, and +inf where that is not below
    SIGMA_CLAMP (past the clamp alpha stops falling with sigma) or is NaN.
    The kernels compute it as ``__fadd_rn(logf(__fmul_rn(opac, 255.f)),
    1e-4f)`` once per staged slot.
    """
    cut = torch.log(opacity * 255.0) + SIGMA_CUT_MARGIN
    return torch.where(cut < SIGMA_CLAMP, cut,
                       torch.full_like(cut, float("inf")))


def sigma_cut_extent(conic: torch.Tensor, cut: torch.Tensor):
    """Half-extents (eu, ev), float64, of the box of pixel offsets (du, dv)
    from a splat's centre at which a pair can be live: a pair outside it
    has float32 sigma beyond ``cut`` (:func:`sigma_cut`).  The compositing
    kernels test it once per slot against each warp's block of pixels and
    skip the slot in warps it cannot reach.

    The box is that of the ellipse 0.5 d^T M d <= 1.02 cut + 0.01, M =
    [[a, b], [b, c]] from ``conic`` [..., 3], widened by 0.01: float32
    sigma errs from the exact form by under 1e-6 (a du^2 + c dv^2) / 2,
    which is under 1% of the exact form where M's eigenvalues differ by
    under 1e4 times.  +inf where that does not hold (or a value is not
    finite, or the cut is infinite); -inf where the cut is negative, since
    then no pair is live.
    """
    a, b, c = (conic[..., i].double() for i in range(3))
    cut = cut.double()
    det = a * c - b * b
    tr = a + c
    lmin = 0.5 * (tr - torch.sqrt((a - c) ** 2 + 4.0 * b * b))
    ok = (a > 0) & (c > 0) & (det > 0) & (lmin * 1e4 >= tr) \
        & (cut < SIGMA_CLAMP)
    k = 2.0 * (1.02 * torch.clamp(cut, min=0.0) + 0.01)
    inf = torch.full_like(a, float("inf"))
    eu = torch.where(ok, torch.sqrt(k * c / det) + 0.01, inf)
    ev = torch.where(ok, torch.sqrt(k * a / det) + 0.01, inf)
    none = cut < 0
    return torch.where(none, -inf, eu), torch.where(none, -inf, ev)


def pixel_centers(tile_ids: torch.Tensor, ntx: int, ts: int):
    """Pixel-centre coordinates (up, vp), each [T, ts*ts], of the given
    tiles; pixel p of a tile is row p // ts, column p % ts."""
    p = torch.arange(ts * ts, device=tile_ids.device)
    up = (tile_ids % ntx)[:, None] * ts + (p % ts)[None, :]
    vp = (tile_ids // ntx)[:, None] * ts + (p // ts)[None, :]
    return up.to(torch.float32) + 0.5, vp.to(torch.float32) + 0.5


class _Chain(NamedTuple):
    """The forward chain of a [T, P, K] chunk, as the backward needs it."""

    du: torch.Tensor
    dv: torch.Tensor
    sigma: torch.Tensor
    alpha_raw: torch.Tensor   # opacity * exp(-clip(sigma, 0, 50))
    keep: torch.Tensor        # live: masked in, sigma >= 0, alpha >= cutoff
    alpha: torch.Tensor
    log1m: torch.Tensor       # log1p(-alpha)
    cum_excl: torch.Tensor    # log-transmittance in front of each slot
    cum_incl: torch.Tensor    # ... and after it
    carry: torch.Tensor       # [T, P] log-transmittance after the window
    w: torch.Tensor           # alpha * T_excl
    tpix_raw: torch.Tensor    # depth + plane . (du, dv)
    tpix: torch.Tensor        # tpix_raw clamped to the near plane


def _chain(g, msk, up, vp, near_plane) -> _Chain:
    k = g.shape[1]
    du = up[:, :, None] - g[:, None, :, 0]                      # [T, P, K]
    dv = vp[:, :, None] - g[:, None, :, 1]
    a = g[:, None, :, 2]
    b = g[:, None, :, 3]
    c = g[:, None, :, 4]
    sigma = 0.5 * (a * du * du + c * dv * dv) + b * du * dv
    alpha_raw = g[:, None, :, 8] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
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
    tpix_raw = g[:, None, :, 5] + g[:, None, :, 6] * du + g[:, None, :, 7] * dv
    tpix = torch.clamp(tpix_raw, min=near_plane)
    return _Chain(du, dv, sigma, alpha_raw, keep, alpha, log1m, cum_excl,
                  cum_incl, carry, w, tpix_raw, tpix)


def _fused_chunk(g, msk, up, vp, near_plane, bank_prefix):
    ch = _chain(g, msk, up, vp, near_plane)
    k = g.shape[1]
    out_v = torch.einsum("tpk,tkv->tpv", ch.w, g[..., G_VALS:])
    alpha_out = 1.0 - torch.exp(ch.carry)
    depth_acc = torch.sum(ch.w * ch.tpix, dim=-1)
    # Median: first live slot where the accumulated opacity crosses 1/2,
    # else the first max-weight slot -- one first-max over a single key.
    crossed = (ch.cum_incl <= LOG_HALF) & (ch.alpha > 0.0)
    kk = torch.arange(k, device=g.device)
    rank_key = 2.0 + (k - kk).to(torch.float32) / k
    med_key = torch.where(crossed, rank_key, ch.w)
    idx = torch.argmax(med_key, dim=-1)
    median = torch.gather(ch.tpix, -1, idx[..., None])[..., 0]
    median = torch.where(alpha_out > 0.0, median, torch.zeros_like(median))
    out = (out_v, alpha_out, depth_acc, median, idx.to(torch.int32))
    if bank_prefix:
        # [NB, T, P]: the carry in front of each PREFIX_BATCH-slot batch.
        out += (ch.cum_excl[..., ::PREFIX_BATCH].permute(2, 0, 1),)
    return out


def fused_forward(g: torch.Tensor, mask: torch.Tensor, ntx: int, ts: int,
                  near_plane: float, tile_chunk: int = 64,
                  bank_prefix: bool = False):
    """Composite every tile's window front to back (plain version).

    Args:
        g: [T, K, 9 + V] float32 gathered per-splat rows in the ``G_VALS``
            column layout, front to back along K.
        mask: [T, K] float32, 1.0 for live window slots, 0.0 for dead ones.
        ntx: tiles per image row; tile t covers column t % ntx, row t // ntx.
        ts: tile size in pixels (P = ts * ts pixels per tile).
        near_plane: lower clamp of the per-pixel splat depth.
        tile_chunk: tiles per dense chunk.
        bank_prefix: also return the residual of the backward kernel.

    Returns:
        (out_v [T, P, V], alpha [T, P], depth_acc [T, P], median [T, P],
        med_idx [T, P] int32): the composited value channels, the
        accumulated opacity, the unnormalized expected depth, the median
        depth (0 where alpha is 0) and the window slot it came from.  With
        ``bank_prefix``, a sixth output ``prefix`` [ceil(K / 64), T, P]
        float32: the log-transmittance in front of slot 64 b, for each
        batch b, as the kernel carries it.
    """
    t = g.shape[0]
    up, vp = (x.to(g.dtype) for x in pixel_centers(
        torch.arange(t, device=g.device), ntx, ts))
    parts = [
        _fused_chunk(g[s:s + tile_chunk], mask[s:s + tile_chunk],
                     up[s:s + tile_chunk], vp[s:s + tile_chunk], near_plane,
                     bank_prefix)
        for s in range(0, t, tile_chunk)
    ]
    outs = [torch.cat(xs, dim=0) for xs in zip(*(p[:5] for p in parts))]
    if bank_prefix:
        outs.append(torch.cat([p[5] for p in parts], dim=1))
    return tuple(outs)


def _backward_chunk(g, msk, up, vp, idx, t_total, g_v, g_alpha, g_depth,
                    g_med, near_plane):
    """``fused_bwd_from_g`` of the JAX package on one chunk of tiles."""
    ch = _chain(g, msk, up, vp, near_plane)
    k = g.shape[1]
    # r_k = dL/dw_k; the exclusive suffix sum_{k > i} w_k r_k carries the
    # back-to-front recurrence.
    r = torch.einsum("tpv,tkv->tpk", g_v, g[..., G_VALS:]) \
        + g_depth[..., None] * ch.tpix
    s = ch.w * r
    incl = torch.flip(torch.cumsum(torch.flip(s, [-1]), -1), [-1])
    suffix = torch.cat([incl[..., 1:], torch.zeros_like(incl[..., :1])], -1)
    inv1m = torch.exp(-ch.log1m)   # 1 / (1 - alpha); 1 at dead slots
    t_excl = torch.exp(ch.cum_excl)
    d_alpha = (t_excl * r - suffix * inv1m
               + (g_alpha * t_total)[..., None] * inv1m)

    # The median's depth flows to its slot (the selection is constant).
    g_med = torch.where(t_total < 1.0, g_med, torch.zeros_like(g_med))
    onehot = (torch.arange(k, device=g.device) == idx[..., None].long())
    d_tpix = ch.w * g_depth[..., None] + g_med[..., None] * onehot
    zero = torch.zeros_like(d_tpix)
    d_tpix = torch.where(ch.tpix_raw >= near_plane, d_tpix, zero)

    d_alpha_raw = torch.where(ch.keep & (ch.alpha_raw < ALPHA_MAX), d_alpha,
                              zero)
    d_opac = torch.sum(
        d_alpha_raw * torch.exp(-torch.clamp(ch.sigma, 0.0, 50.0)), dim=1)
    d_sigma = torch.where((ch.sigma >= 0.0) & (ch.sigma <= 50.0),
                          -ch.alpha_raw * d_alpha_raw, zero)

    # Tile-local pixel moments of d_sigma (1, u, v, u^2, uv, v^2) and
    # d_tpix (1, u, v); moments_to_dg recombines them per splat.
    u0, v0 = up[:, :1], vp[:, :1]
    ul, vl = up - u0, vp - v0
    basis = torch.stack([torch.ones_like(ul), ul, vl, ul * ul, ul * vl,
                         vl * vl], dim=-1)                     # [T, P, 6]
    S = torch.einsum("tpk,tpm->tkm", d_sigma, basis)
    T3 = torch.einsum("tpk,tpm->tkm", d_tpix, basis[..., :3])
    d_vals = torch.einsum("tpk,tpv->tkv", ch.w, g_v)
    return moments_to_dg(g, S, T3, d_opac, d_vals, u0, v0)


def moments_to_dg(g, S, T3, d_opac, d_vals, u0, v0) -> torch.Tensor:
    """Recombine tile-local pixel moments into per-splat gradients.

    ``S`` [T, K, 6] are the moments of d_sigma against (1, u, v, u^2, uv,
    v^2), ``T3`` [T, K, 3] those of d_tpix against (1, u, v), ``d_opac``
    [T, K] and ``d_vals`` [T, K, V]; ``u0``/``v0`` [T, 1] are each tile's
    first pixel centre.  Returns d_g [T, K, 9 + V] in g's column layout.
    """
    s00, s10, s01 = S[..., 0], S[..., 1], S[..., 2]
    s20, s11, s02 = S[..., 3], S[..., 4], S[..., 5]
    t00, t10, t01 = T3[..., 0], T3[..., 1], T3[..., 2]
    mu = g[..., 0] - u0
    mv = g[..., 1] - v0
    ga, gb, gc = g[..., 2], g[..., 3], g[..., 4]
    pu, pv = g[..., 6], g[..., 7]
    # sum_p d_sigma * du = s10 - mu * s00 (and dv alike).
    sdu = s10 - mu * s00
    sdv = s01 - mv * s00
    cols = [
        -(ga * sdu + gb * sdv + pu * t00),
        -(gc * sdv + gb * sdu + pv * t00),
        0.5 * (s20 - 2.0 * mu * s10 + mu * mu * s00),
        s11 - mu * s01 - mv * s10 + mu * mv * s00,
        0.5 * (s02 - 2.0 * mv * s01 + mv * mv * s00),
        t00,
        t10 - mu * t00,
        t01 - mv * t00,
        d_opac,
    ]
    return torch.cat([torch.stack(cols, dim=-1), d_vals], dim=-1)


def fused_backward(g: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
                   t_total: torch.Tensor, g_v: torch.Tensor,
                   g_alpha: torch.Tensor, g_depth: torch.Tensor,
                   g_med: torch.Tensor, ntx: int, ts: int, near_plane: float,
                   tile_chunk: int = 64) -> torch.Tensor:
    """Backward of :func:`fused_forward` (plain version): the JAX package's
    ``fused_bwd_from_g`` followed by ``moments_to_dg``.

    Args:
        g, mask: the forward's inputs.
        idx: [T, P] int32 median slot of the forward; t_total: [T, P]
            transmittance after the window (1 - alpha).
        g_v [T, P, V], g_alpha, g_depth, g_med [T, P]: cotangents of the
            forward's out_v, alpha, depth_acc and median.

    Returns:
        d_g [T, K, 9 + V]; exactly 0 at masked and dead slots.  Its columns
        0:2 are the gradient of an additive screen-space sink on the means.
    """
    t = g.shape[0]
    up, vp = (x.to(g.dtype) for x in pixel_centers(
        torch.arange(t, device=g.device), ntx, ts))
    parts = []
    for s in range(0, t, tile_chunk):
        sl = slice(s, s + tile_chunk)
        parts.append(_backward_chunk(
            g[sl], mask[sl], up[sl], vp[sl], idx[sl], t_total[sl], g_v[sl],
            g_alpha[sl], g_depth[sl], g_med[sl], near_plane))
    return torch.cat(parts, dim=0)

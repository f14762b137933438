"""Per-tile compositing over chunk-aligned intersection segments: the plain
versions, the wrappers of their kernels (``csrc/composite_fwd.cu`` and
``csrc/composite_bwd.cu``) and the autograd function that pairs them.

Replaces the JAX package's Pallas ``ops/pallas/composite.py::
composite_tiles_fwd`` and ``composite_tiles_bwd_call`` (and the
``custom_vjp`` ``composite_tiles`` around them), the compositor of
``RenderOptions(backend="pallas")``.  For CPU tensors each wrapper runs its
plain version; for CUDA tensors it runs its kernel or raises.

The wrappers read each slot's row through the aligned ids: slot ``s`` of
the aligned intersection list (``ops/tiles.py::align_segments``) is the row
``per_gauss[aligned_gid[s]]`` of the [N, Dp] per-gaussian matrix
(``ops/rasterize.py``'s PG_* columns, padded to a multiple of 8), plus
``sink[:, s]`` on its (u, v) when a per-slot sink [2, M] is given.  That is
column ``s`` of the JAX package's packed matrix ``isect`` [D, M]
(``ops/rasterize.py::pack_intersections``, with the sink added), which the
packed plain versions (:func:`composite_tiles_fwd_plain`,
:func:`composite_tiles_bwd_plain`) walk; the gather plain versions are
those composed with the gather (:func:`gather_slots`).  The backward's
gradient is slot-major, [M, Dp]: the rows the sorted segment sum reduces
per gaussian.  Each tile owns the slots ``starts[t] : starts[t] + lens[t]``
(``starts`` are multiples of CHUNK) and walks them front to back in
CHUNK-slot chunks; only slots below ``lens[t]`` are read.  Row layout of
``isect`` (the columns of ``per_gauss``):

    0 u, 1 v | 2 a, 3 b, 4 c (conic) | 5 depth, 6 plane_u, 7 plane_v |
    8 opacity | 9, 10, 11 normal | 12.. the C colour channels | padding

Per (pixel, slot) of a chunk: alpha as in ``core/compositing.py::
splat_alpha``, ``cum`` the in-chunk inclusive sum of log(1 - alpha) slot
by slot, ``lc = log_t + cum`` with ``log_t`` the log-transmittance carried
into the chunk, ``w = alpha * (exp(lc) * (1 / (1 - alpha)))``.  The median
is the depth of the first live slot with ``lc <= log 1/2``, else of the
first slot of maximum weight (strict ``>`` across slots), and 0 where the
accumulated alpha ``1 - exp(log_t)`` is 0.  Before each chunk the tile
goes on only while some pixel has ``log_t > log(stop_threshold)``; the
number of chunks it ran, ``nchunks``, is the backward's residual.

Both plain versions take every discrete decision (live slot, median slot,
maximum weight, early exit) in the kernels' order of operations, with the
in-chunk log-transmittance summed slot by slot, so that they agree with the
kernels bit for bit on those decisions; sums over slots and pixels are
taken in other orders and agree within float rounding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.compositing import (ALPHA_CUTOFF, ALPHA_MAX, LOG_HALF,
                                 pixel_centers)
from ..segsum import segment_sum, spread_masked
from . import build
from .build import KERNEL_TILE_SIZE, check_tensor

CHUNK = 128
D_BASE = 12
KERNEL_COLOR_CHANNELS = (3, 16)   # RGB, and RGB ++ 13 latents
# Tiles the plain versions composite at once (memory stays bounded).
_PLAIN_TILES = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


@functools.cache
def _banked() -> int:
    """Entries kernel 6 banks per (tile, chunk, pixel) in its scratch."""
    return build.load("composite_bwd").composite_tiles_bwd_banked()


def log_stop(stop_threshold: float) -> float:
    """log(stop_threshold) in float32, as the JAX kernel takes it (-inf for
    0: the tile never exits early)."""
    return float(torch.log(torch.tensor(stop_threshold, dtype=torch.float32)))


# ------------------------------------------------------------ plain versions
def _chunk_counts(starts, lens, m_al, max_chunks):
    """[T] chunks of each segment the compositor may walk: its length in
    chunks, at most ``max_chunks`` and never past the matrix's end."""
    n = torch.clamp((lens + CHUNK - 1) // CHUNK, max=max_chunks)
    return torch.minimum(n, (m_al - starts[:-1]) // CHUNK)


class _Chunk:
    """One chunk of a group of tiles: the chain of every (pixel, slot)."""

    def __init__(self, isect, starts, lens, tiles, ci, up, vp, n_rows,
                 near_plane):
        m_al = isect.shape[1]
        lane = torch.arange(CHUNK, device=isect.device)
        col0 = starts[tiles].long() + ci * CHUNK
        self.cols = torch.clamp(col0[:, None] + lane, max=m_al - 1)
        b = isect[:n_rows][:, self.cols].permute(1, 0, 2)   # [Tg, R, CHUNK]
        self.b = b
        valid = (ci * CHUNK + lane)[None, :] < lens[tiles][:, None]
        du = up[:, :, None] - b[:, None, 0]                  # [Tg, P, CHUNK]
        dv = vp[:, :, None] - b[:, None, 1]
        self.du, self.dv = du, dv
        self.sigma = 0.5 * (b[:, None, 2] * du * du
                            + b[:, None, 4] * dv * dv) \
            + b[:, None, 3] * du * dv
        self.e = torch.exp(-torch.clamp(self.sigma, 0.0, 50.0))
        self.raw = b[:, None, 8] * self.e
        alpha = torch.clamp(self.raw, max=ALPHA_MAX)
        self.keep = valid[:, None, :] & (alpha >= ALPHA_CUTOFF) \
            & (self.sigma >= 0.0)
        self.alpha = torch.where(self.keep, alpha, torch.zeros_like(alpha))
        log1m = torch.log1p(-self.alpha)
        # The in-chunk inclusive sum, slot by slot (the kernels' order).
        self.cum = torch.empty_like(log1m)
        run = torch.zeros_like(log1m[..., 0])
        for j in range(CHUNK):
            run = run + log1m[..., j]
            self.cum[..., j] = run
        self.t_raw = b[:, None, 5] + b[:, None, 6] * du + b[:, None, 7] * dv
        self.tpix = torch.clamp(self.t_raw, min=near_plane)
        self.inv1m = 1.0 / (1.0 - self.alpha)

    def weights(self, log_t):
        """(lc, t_in, w) for the log-transmittance ``log_t`` [Tg, P]
        carried into the chunk."""
        lc = log_t[..., None] + self.cum
        t_in = torch.exp(lc) * self.inv1m
        return lc, t_in, self.alpha * t_in

    def fired(self, lc):
        return (lc <= LOG_HALF) & self.keep

    def g_w(self, g_color, g_normal, g_depth, n_color):
        """dL/dw per (pixel, slot): g_color . colour + g_normal . normal +
        g_depth * tpix."""
        b = self.b
        return (torch.einsum("tpc,tck->tpk", g_color,
                             b[:, D_BASE:D_BASE + n_color])
                + torch.einsum("tpc,tck->tpk", g_normal, b[:, 9:12])
                + g_depth[..., None] * self.tpix)


def _first(mask):
    """(any, index of the first True) along the last axis."""
    return mask.any(-1), torch.argmax(mask.to(torch.uint8), -1)


def _pick(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def composite_tiles_fwd_plain(isect, starts, lens, num_tiles_x, tile_size,
                              n_color, near_plane=0.01,
                              stop_threshold=1e-4, max_chunks=64):
    """Plain version of :func:`composite_tiles_fwd`."""
    t_all = lens.shape[0]
    p = tile_size * tile_size
    stop = log_stop(stop_threshold)
    n_all = _chunk_counts(starts, lens, isect.shape[1], max_chunks)
    outs, counts = [], []
    for s in range(0, t_all, _PLAIN_TILES):
        tiles = torch.arange(s, min(s + _PLAIN_TILES, t_all),
                             device=isect.device)
        tg = tiles.shape[0]
        up, vp = pixel_centers(tiles, num_tiles_x, tile_size)

        def zeros(*shape):
            return torch.zeros((tg, p) + shape, dtype=isect.dtype,
                               device=isect.device)

        log_t, depth_sum, median, wmax, t_wmax = (zeros() for _ in range(5))
        color, normal = zeros(n_color), zeros(3)
        found = torch.zeros((tg, p), dtype=torch.bool, device=isect.device)
        nch = torch.zeros(tg, dtype=torch.int32, device=isect.device)
        for ci in range(max_chunks):
            run = (ci < n_all[tiles]) & (torch.amax(log_t, dim=1) > stop)
            if not bool(run.any()):
                break
            ch = _Chunk(isect, starts, lens, tiles, ci, up, vp,
                        D_BASE + n_color, near_plane)
            lc, _, w = ch.weights(log_t)
            r1, r2 = run[:, None], run[:, None, None]
            color = torch.where(r2, color + torch.einsum(
                "tpk,tck->tpc", w, ch.b[:, D_BASE:D_BASE + n_color]), color)
            normal = torch.where(r2, normal + torch.einsum(
                "tpk,tck->tpc", w, ch.b[:, 9:12]), normal)
            depth_sum = torch.where(r1, depth_sum + torch.sum(w * ch.tpix, -1),
                                    depth_sum)
            # Maximum weight: the first slot of the chunk's maximum, taken
            # only if strictly above the earlier chunks' maximum.
            w_max, w_arg = torch.max(w, -1)
            new_max = r1 & (w_max > wmax)
            t_wmax = torch.where(new_max, _pick(ch.tpix, w_arg), t_wmax)
            wmax = torch.where(new_max, w_max, wmax)
            # Median: the first fired live slot, once.
            any_f, f_arg = _first(ch.fired(lc))
            take = r1 & any_f & ~found
            median = torch.where(take, _pick(ch.tpix, f_arg), median)
            found = found | (r1 & any_f)
            log_t = torch.where(r1, log_t + ch.cum[..., -1], log_t)
            nch += run.to(torch.int32)
        alpha = 1.0 - torch.exp(log_t)
        median = torch.where(found, median, t_wmax)
        median = torch.where(alpha > 0.0, median, torch.zeros_like(median))
        outs.append(torch.cat([color, normal, alpha[..., None],
                               depth_sum[..., None], median[..., None]], -1))
        counts.append(nch)
    if not outs:
        return (torch.zeros((0, p, n_color + 6), dtype=isect.dtype,
                            device=isect.device),
                torch.zeros(0, dtype=torch.int32, device=isect.device))
    return torch.cat(outs), torch.cat(counts)


def composite_tiles_bwd_plain(isect, starts, lens, num_tiles_x, nchunks,
                              g_packed, tile_size, n_color, near_plane,
                              max_chunks):
    """Plain version of :func:`composite_tiles_bwd_call`."""
    t_all = lens.shape[0]
    d_isect = torch.zeros_like(isect)
    n_rows = D_BASE + n_color
    # The forward's counts, never past the segment's walk (as the kernel).
    n_all = torch.minimum(nchunks, _chunk_counts(starts, lens, isect.shape[1],
                                                 max_chunks))
    for s in range(0, t_all, _PLAIN_TILES):
        tiles = torch.arange(s, min(s + _PLAIN_TILES, t_all),
                             device=isect.device)
        up, vp = pixel_centers(tiles, num_tiles_x, tile_size)
        nc = n_all[tiles]
        g = g_packed[tiles]
        g_color, g_normal = g[..., :n_color], g[..., n_color:n_color + 3]
        g_alpha, g_depth, g_med = (g[..., n_color + i] for i in (3, 4, 5))
        n_run = int(nc.max()) if tiles.numel() else 0

        def chunk(ci):
            return _Chunk(isect, starts, lens, tiles, ci, up, vp, n_rows,
                          near_plane)

        # Phase 1: replay the forward; keep each chunk's entry log T and
        # its sum of g_w * w.
        log_t = torch.zeros_like(up)
        wmax = torch.zeros_like(up)
        crossed = torch.zeros(up.shape, dtype=torch.bool, device=up.device)
        logt_in, gw_sum = [], []
        for ci in range(n_run):
            run = (ci < nc)[:, None]
            ch = chunk(ci)
            lc, _, w = ch.weights(log_t)
            crossed = crossed | (run & ch.fired(lc).any(-1))
            logt_in.append(log_t)
            gw = ch.g_w(g_color, g_normal, g_depth, n_color)
            gw_sum.append(torch.where(run, torch.sum(gw * w, -1),
                                      torch.zeros_like(log_t)))
            wmax = torch.where(run, torch.maximum(wmax, torch.amax(w, -1)),
                               wmax)
            log_t = torch.where(run, log_t + ch.cum[..., -1], log_t)
        t_final = torch.exp(log_t)

        # Phase 2: per-slot gradients, chunk by chunk.
        seen_med = torch.zeros_like(crossed)
        seen_fb = torch.zeros_like(crossed)
        for ci in range(n_run):
            run = ci < nc
            ch = chunk(ci)
            lc, t_in, w = ch.weights(logt_in[ci])
            gw = ch.g_w(g_color, g_normal, g_depth, n_color)
            gww = gw * w
            incl = torch.flip(torch.cumsum(torch.flip(gww, [-1]), -1), [-1])
            within = torch.cat(
                [incl[..., 1:], torch.zeros_like(incl[..., :1])], -1)
            s_after = torch.zeros_like(log_t)
            for c in range(ci + 1, n_run):
                s_after = s_after + torch.where(
                    (c < nc)[:, None], gw_sum[c], torch.zeros_like(log_t))
            suffix = within + s_after[..., None]
            d_alpha = (gw * t_in - suffix * ch.inv1m
                       + (g_alpha * t_final)[..., None] * ch.inv1m)
            zero = torch.zeros_like(d_alpha)
            d_alpha = torch.where(ch.keep, d_alpha, zero)

            # Median routing: the forward's first fired live slot, else its
            # first slot of maximum weight.
            any_f, f_arg = _first(ch.fired(lc))
            lane = torch.arange(CHUNK, device=up.device)
            take_med = (lane == f_arg[..., None]) & (any_f & ~seen_med)[
                ..., None]
            seen_med = seen_med | any_f
            cand = (w == wmax[..., None]) & (wmax > 0.0)[..., None] \
                & ~crossed[..., None] & ~seen_fb[..., None]
            any_c, c_arg = _first(cand)
            first_cand = (lane == c_arg[..., None]) & any_c[..., None]
            seen_fb = seen_fb | any_c
            sel = torch.where(crossed[..., None], take_med, first_cand)
            g_t = g_depth[..., None] * w + torch.where(
                sel, g_med[..., None], zero)
            g_t = torch.where(ch.keep & (ch.t_raw > near_plane), g_t, zero)

            d_raw = torch.where(ch.raw < ALPHA_MAX, d_alpha, zero)
            d_sigma = -ch.raw * d_raw
            b = ch.b[:, None]
            du, dv = ch.du, ch.dv
            d_du = d_sigma * (b[:, :, 2] * du + b[:, :, 3] * dv) \
                + g_t * b[:, :, 6]
            d_dv = d_sigma * (b[:, :, 4] * dv + b[:, :, 3] * du) \
                + g_t * b[:, :, 7]
            rows = torch.cat([
                torch.stack([
                    -d_du.sum(1), -d_dv.sum(1),
                    (0.5 * du * du * d_sigma).sum(1),
                    (du * dv * d_sigma).sum(1),
                    (0.5 * dv * dv * d_sigma).sum(1),
                    g_t.sum(1), (g_t * du).sum(1), (g_t * dv).sum(1),
                    (d_raw * ch.e).sum(1)], 1),
                torch.einsum("tpc,tpk->tck", g_normal, w),
                torch.einsum("tpc,tpk->tck", g_color, w)], 1)  # [Tg, R, CH]
            cols = ch.cols[run]
            d_isect[:n_rows, cols.reshape(-1)] = rows[run].permute(
                1, 0, 2).reshape(n_rows, -1)
    return d_isect


def row_width(n_color: int) -> int:
    """Dp: the per-gaussian row width of ``n_color`` colour channels, 12 + C
    padded to a multiple of 8 (as the JAX package pads its packed rows)."""
    return -(-(D_BASE + n_color) // 8) * 8


def gather_slots(per_gauss, aligned_gid, sink=None):
    """The packed matrix [Dp, M] whose column ``s`` is the row
    ``per_gauss[aligned_gid[s]]``, plus ``sink[:, s]`` on (u, v):
    ``ops/rasterize.py::pack_intersections``' matrix with the sink added,
    as the gather plain versions hand it to the packed ones."""
    isect = per_gauss[aligned_gid.long()].T.contiguous()
    if sink is not None:
        isect[:2] += sink
    return isect


def composite_tiles_fwd_gather_plain(per_gauss, aligned_gid, starts, lens,
                                     num_tiles_x, tile_size, n_color,
                                     near_plane=0.01, stop_threshold=1e-4,
                                     max_chunks=64, sink=None):
    """Plain version of :func:`composite_tiles_fwd`: the packed plain version
    on the gathered matrix."""
    return composite_tiles_fwd_plain(
        gather_slots(per_gauss, aligned_gid, sink), starts, lens,
        num_tiles_x, tile_size, n_color, near_plane, stop_threshold,
        max_chunks)


def composite_tiles_bwd_gather_plain(per_gauss, aligned_gid, starts, lens,
                                     num_tiles_x, nchunks, g_packed,
                                     tile_size, n_color, near_plane,
                                     max_chunks, sink=None):
    """Plain version of :func:`composite_tiles_bwd_call`: the packed plain
    version on the gathered matrix, transposed to slot-major rows."""
    return composite_tiles_bwd_plain(
        gather_slots(per_gauss, aligned_gid, sink), starts, lens,
        num_tiles_x, nchunks, g_packed, tile_size, n_color, near_plane,
        max_chunks).T.contiguous()


# ------------------------------------------------------------------ wrappers
def _check_common(name, per_gauss, aligned_gid, sink, starts, lens,
                  tile_size, n_color, max_chunks):
    dev = per_gauss.device
    if n_color not in KERNEL_COLOR_CHANNELS:
        raise ValueError(f"{name}: C={n_color} colour channels; the kernel "
                         f"is built for {KERNEL_COLOR_CHANNELS}")
    if tile_size != KERNEL_TILE_SIZE:
        raise ValueError(f"{name}: tile size {tile_size}; the kernel runs "
                         f"{KERNEL_TILE_SIZE}x{KERNEL_TILE_SIZE} tiles")
    if max_chunks < 1:
        raise ValueError(f"{name}: max_chunks={max_chunks}")
    n, dp = per_gauss.shape[0], row_width(n_color)
    check_tensor(f"{name}: per_gauss", per_gauss, (n, dp), torch.float32,
                 dev)
    if per_gauss.data_ptr() % 16:
        raise ValueError(f"{name}: per_gauss must be 16-byte aligned")
    m = aligned_gid.shape[0]
    check_tensor(f"{name}: aligned_gid", aligned_gid, (m,), torch.int32, dev)
    if sink is not None:
        check_tensor(f"{name}: sink", sink, (2, m), torch.float32, dev)
    t = lens.shape[0]
    check_tensor(f"{name}: starts", starts, (t + 1,), torch.int32, dev)
    check_tensor(f"{name}: lens", lens, (t,), torch.int32, dev)
    return t, m


def composite_tiles_fwd(per_gauss: torch.Tensor, aligned_gid: torch.Tensor,
                        starts: torch.Tensor, lens: torch.Tensor,
                        num_tiles_x: int, tile_size: int, n_color: int,
                        near_plane: float = 0.01,
                        stop_threshold: float = 1e-4, max_chunks: int = 64,
                        sink: torch.Tensor | None = None):
    """Composite every tile's segment (see the module doc).

    Args:
        per_gauss: [N, Dp] float32 per-gaussian rows, Dp =
            :func:`row_width` (n_color).
        aligned_gid: [M] int32 gaussian of each aligned slot, in [0, N)
            below each segment's length.
        starts: [T+1] int32 segment starts, multiples of CHUNK.
        lens: [T] int32 true segment lengths.
        num_tiles_x: tiles per image row.
        max_chunks: at most this many chunks per tile.
        sink: optional [2, M] float32 added to each slot's (u, v).

    Returns:
        (packed [T, P, C+6] float32: colour, normal, alpha, depth_sum
        (unnormalized) and median per pixel; nchunks [T] int32).
    """
    args = (per_gauss, aligned_gid, starts, lens, num_tiles_x, tile_size,
            n_color, near_plane, stop_threshold, max_chunks, sink)
    if per_gauss.device.type == "cpu":
        return composite_tiles_fwd_gather_plain(*args)
    if per_gauss.device.type != "cuda":
        raise ValueError(f"composite_tiles_fwd: unsupported device "
                         f"{per_gauss.device}")
    t, m = _check_common("composite_tiles_fwd", per_gauss, aligned_gid, sink,
                         starts, lens, tile_size, n_color, max_chunks)
    dev = per_gauss.device
    out = torch.empty((t, tile_size * tile_size, n_color + 6),
                      dtype=torch.float32, device=dev)
    nchunks = torch.empty(t, dtype=torch.int32, device=dev)
    if t == 0:
        return out, nchunks
    fn = build.entry("composite_fwd", "composite_tiles_fwd", *[_P] * 5, _I,
                     _L, _I, _I, _F, _F, _I, _P, _P)
    build.launch("composite_tiles_fwd", fn, dev, per_gauss.data_ptr(),
                 aligned_gid.data_ptr(),
                 sink.data_ptr() if sink is not None else None,
                 starts.data_ptr(), lens.data_ptr(), t, m, num_tiles_x,
                 n_color, near_plane, log_stop(stop_threshold), max_chunks,
                 out.data_ptr(), nchunks.data_ptr())
    return out, nchunks


def composite_tiles_bwd_call(per_gauss: torch.Tensor,
                             aligned_gid: torch.Tensor, starts: torch.Tensor,
                             lens: torch.Tensor, num_tiles_x: int,
                             nchunks: torch.Tensor, g_packed: torch.Tensor,
                             tile_size: int, n_color: int, near_plane: float,
                             max_chunks: int,
                             sink: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Backward of :func:`composite_tiles_fwd`: the forward's inputs and
    ``nchunks``, and the cotangent ``g_packed`` [T, P, C+6] of its packed
    maps -> d_slot [M, Dp] float32, each slot's gradient row (the sink's
    gradient is its columns 0 and 1), 0 outside the chunks the forward ran
    and in the padding columns."""
    args = (per_gauss, aligned_gid, starts, lens, num_tiles_x, nchunks,
            g_packed, tile_size, n_color, near_plane, max_chunks, sink)
    if per_gauss.device.type == "cpu":
        return composite_tiles_bwd_gather_plain(*args)
    if per_gauss.device.type != "cuda":
        raise ValueError(f"composite_tiles_bwd_call: unsupported device "
                         f"{per_gauss.device}")
    name = "composite_tiles_bwd_call"
    t, m = _check_common(name, per_gauss, aligned_gid, sink, starts, lens,
                         tile_size, n_color, max_chunks)
    dev = per_gauss.device
    p = tile_size * tile_size
    check_tensor(f"{name}: nchunks", nchunks, (t,), torch.int32, dev)
    check_tensor(f"{name}: g_packed", g_packed, (t, p, n_color + 6),
                 torch.float32, dev)
    d_slot = torch.zeros((m, row_width(n_color)), dtype=torch.float32,
                         device=dev)
    if t == 0:
        return d_slot
    # Per (tile, chunk, pixel): the log T carried into the chunk and the
    # in-chunk carry at each of its batch boundaries.
    scratch = torch.empty((t, max_chunks, _banked(), p), dtype=torch.float32,
                          device=dev)
    fn = build.entry("composite_bwd", "composite_tiles_bwd", *[_P] * 7, _I,
                     _L, _I, _I, _F, _I, _P, _P)
    build.launch(name, fn, dev, per_gauss.data_ptr(), aligned_gid.data_ptr(),
                 sink.data_ptr() if sink is not None else None,
                 starts.data_ptr(), lens.data_ptr(), nchunks.data_ptr(),
                 g_packed.data_ptr(), t, m, num_tiles_x, n_color, near_plane,
                 max_chunks, scratch.data_ptr(), d_slot.data_ptr())
    return d_slot


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, per_gauss, sink, aligned_gid, valid, starts, lens,
                num_tiles_x, tile_size, n_color, near_plane, stop_threshold,
                max_chunks):
        out, nchunks = composite_tiles_fwd(
            per_gauss, aligned_gid, starts, lens, num_tiles_x, tile_size,
            n_color, near_plane, stop_threshold, max_chunks, sink)
        ctx.save_for_backward(per_gauss, sink, aligned_gid, valid, starts,
                              lens, nchunks)
        ctx.args = (num_tiles_x, tile_size, n_color, near_plane, max_chunks)
        return out

    @staticmethod
    def backward(ctx, g):
        per_gauss, sink, aligned_gid, valid, starts, lens, nchunks = \
            ctx.saved_tensors
        ntx, ts, n_color, near_plane, max_chunks = ctx.args
        d_slot = composite_tiles_bwd_call(
            per_gauss, aligned_gid, starts, lens, ntx, nchunks,
            g.contiguous(), ts, n_color, near_plane, max_chunks, sink)
        # Per-gaussian sums of the slots' rows: the sorted segment sum
        # (padding slots spread, their rows 0).
        n = per_gauss.shape[0]
        d_per_gauss = segment_sum(spread_masked(aligned_gid, valid, n),
                                  d_slot, n)
        d_sink = (d_slot[:, :2].T.contiguous() if ctx.needs_input_grad[1]
                  else None)
        return (d_per_gauss, d_sink) + (None,) * 10


def composite_tiles(per_gauss: torch.Tensor, aligned_gid: torch.Tensor,
                    valid: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, num_tiles_x: int, tile_size: int,
                    n_color: int, near_plane: float, stop_threshold: float,
                    max_chunks: int,
                    sink: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`composite_tiles_fwd`'s packed maps under autograd, with
    :func:`composite_tiles_bwd_call` as the backward.  Gradients reach
    ``per_gauss`` (each slot's row summed per gaussian by the sorted
    segment sum over ``aligned_gid``, ``valid`` [M] marking the real
    slots) and ``sink``."""
    return _CompositeTiles.apply(per_gauss, sink, aligned_gid, valid, starts,
                                 lens, num_tiles_x, tile_size, n_color,
                                 near_plane, stop_threshold, max_chunks)

"""Seeded edge-case inputs of the two compositors.

One list of splats per tile feeds both input formats: the batched
compositor's window rows ``g`` [T, K, 9 + V] with their mask [T, K]
(``core/compositing.py::fused_forward``, kernels 2 and 3) and the per-tile
compositor's packed intersection matrix ``isect`` [D, M] with its
chunk-aligned segments (``ops/cuda/composite.py``, kernels 5 and 6), where
V = 3 + C (normal ++ C colours).  The tiles, 8 x 4 of 16x16 pixels:

- tile 0 and tile 1: a pixel that never crosses 1/2 and sees two splats of
  exactly equal weight, the first in slot 0 and the second in slot 128 (in
  another batch of the window and another chunk of the segment); the
  second splat's opacity is searched, ulp by ulp on the given device, so
  that the weights tie as the window (tile 0) and the per-tile (tile 1)
  compositors compute them there;
- tiles 2-7: segments of 1, 63, 64, 65, 127 and 129 slots;
- tile 8: 200 slots whose slots 64-127 lie far outside the tile, so the
  window's second batch and the first chunk's second batch are all dead;
- tile 9: 300 large, nearly opaque slots, which end early at
  ``stop_threshold`` 1e-4;
- tile 10: 100 window slots of which every fifth is masked out, between
  live ones (the segment holds the 80 masked-in ones);
- the other tiles are empty.

The window's slots past a tile's splats and the matrix's padding hold
finite noise, which the compositors must mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NTX, NTY, TS = 8, 4, 16
K = 384            # window slots: six 64-slot batches
CHUNK = 128        # the per-tile compositor's chunk
MAX_CHUNKS = 3
TIE_TILES = (0, 1)            # window tie, per-tile tie
TIE_PIXEL = (3, 3)            # (column, row) in its tile
TIE_SLOTS = (0, 128)
TIE_ALPHA = 0.15              # the first tied splat's alpha at the pixel
SEGMENTS = (1, 63, 64, 65, 127, 129)   # tiles 2-7
DEAD_BATCH_TILE, OPAQUE_TILE, HOLE_TILE = 8, 9, 10


class EdgeCases(NamedTuple):
    g: torch.Tensor        # [T, K, 9 + V] window rows
    mask: torch.Tensor     # [T, K] float32
    isect: torch.Tensor    # [D, M] packed intersections, D = 12 + C padded
    starts: torch.Tensor   # [T + 1] int32, multiples of CHUNK
    lens: torch.Tensor     # [T] int32
    ntx: int
    max_chunks: int


def _random_rows(rng, n, tile, v, size=(1.0, 9.0), opac=(0.02, 0.999)):
    """[n, 9 + v] anisotropic splats around the tile, front to back."""
    u0, v0 = tile % NTX * TS, tile // NTX * TS
    sx, sy = rng.uniform(*size, (2, n))
    rho = rng.uniform(-0.8, 0.8, n)
    ca, cb, cc = sx * sx + 0.3, rho * sx * sy, sy * sy + 0.3
    det = ca * cc - cb * cb
    geo = np.stack([
        u0 + rng.uniform(-10, 26, n), v0 + rng.uniform(-10, 26, n),
        cc / det, -cb / det, ca / det, np.sort(rng.uniform(0.5, 6.0, n)),
        rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n),
        rng.uniform(*opac, n)], axis=1)
    return np.concatenate([geo, rng.uniform(-1.0, 1.0, (n, v))], axis=1)


def _tie_rows(rng, tile, v, n=140):
    """A tie tile's splats: slots TIE_SLOTS centred on the tie pixel (sigma
    0 there, so alpha is the opacity; too narrow to reach a neighbour),
    the others small splats in the tile's right half, dead at the pixel.
    The second tied opacity is set by the caller."""
    u0, v0 = tile % NTX * TS, tile // NTX * TS
    s = rng.uniform(0.5, 1.5, (2, n))
    rows = np.concatenate([np.stack([
        u0 + rng.uniform(9.0, 16.0, n), v0 + rng.uniform(0.0, 16.0, n),
        1.0 / s[0] ** 2, np.zeros(n), 1.0 / s[1] ** 2,
        np.sort(rng.uniform(0.5, 6.0, n)), rng.uniform(-0.05, 0.05, n),
        rng.uniform(-0.05, 0.05, n), rng.uniform(0.05, 0.9, n)], axis=1),
        rng.uniform(-1.0, 1.0, (n, v))], axis=1)
    for slot, depth in zip(TIE_SLOTS, (2.0, 3.0)):
        rows[slot, :9] = (u0 + TIE_PIXEL[0] + 0.5, v0 + TIE_PIXEL[1] + 0.5,
                          20.0, 0.0, 20.0, depth, 0.0, 0.0, TIE_ALPHA)
    return rows


def _around(x: torch.Tensor, n=256) -> torch.Tensor:
    """The 2n + 1 float32 values nearest ``x`` (a positive scalar)."""
    bits = x.view(torch.int32) + torch.arange(-n, n + 1, device=x.device,
                                              dtype=torch.int32)
    return bits.view(torch.float32)


def tied_opacity(per_tile: bool, device) -> float:
    """The second tied splat's alpha: float32 w of slot TIE_SLOTS[1] equals
    the first's, as ``fused_forward`` (w = alpha exp(carry in front)) or
    the per-tile plain version (w = alpha (exp(lc) (1 / (1 - alpha))), lc
    the carry after the slot) computes it on ``device``, where the pixel's
    only live slots are the two."""
    f32 = dict(dtype=torch.float32, device=device)
    a1 = torch.tensor(TIE_ALPHA, **f32)
    zero = torch.zeros((), **f32)
    l1 = zero + torch.log1p(-a1)
    if per_tile:
        w1 = a1 * (torch.exp(zero + l1) * (1.0 / (1.0 - a1)))
    else:
        w1 = a1 * torch.exp(zero)
    a2 = _around(w1 / torch.exp(l1))   # w2 ~ a2 T, T = exp(l1) in front
    if per_tile:
        w2 = a2 * (torch.exp(l1 + (zero + torch.log1p(-a2)))
                   * (1.0 / (1.0 - a2)))
    else:
        w2 = a2 * torch.exp(l1)
    hit = torch.nonzero(w2 == w1)
    if hit.numel() == 0:
        raise RuntimeError("no float32 opacity ties the two weights")
    return float(a2[hit[0, 0]])


def _tile_rows(v, device, seed):
    rng = np.random.default_rng(seed)
    rows, masks = [], []
    for tile in range(NTX * NTY):
        keep = None
        if tile in TIE_TILES:
            r = _tie_rows(rng, tile, v)
            r[TIE_SLOTS[1], 8] = tied_opacity(tile == TIE_TILES[1], device)
        elif 2 <= tile < 2 + len(SEGMENTS):
            r = _random_rows(rng, SEGMENTS[tile - 2], tile, v)
        elif tile == DEAD_BATCH_TILE:
            r = _random_rows(rng, 200, tile, v)
            r[64:128, 0] += 1000.0
        elif tile == OPAQUE_TILE:
            r = _random_rows(rng, 300, tile, v, size=(6.0, 14.0),
                             opac=(0.6, 0.999))
        elif tile == HOLE_TILE:
            r = _random_rows(rng, 100, tile, v)
            keep = np.arange(100) % 5 != 4
        else:
            r = np.zeros((0, 9 + v))
        rows.append(r)
        masks.append(np.ones(len(r), bool) if keep is None else keep)
    return rows, masks, rng


def edge_cases(v: int, device="cpu", seed: int = 0) -> EdgeCases:
    """The edge-case inputs of both compositors with V = v value channels
    (C = v - 3 colour channels), float32 on ``device``."""
    rows, masks, rng = _tile_rows(v, device, seed)
    t = NTX * NTY
    g = rng.uniform(-1.0, 1.0, (t, K, 9 + v))
    mask = np.zeros((t, K))
    lens = np.array([int(m.sum()) for m in masks], np.int32)
    starts = np.concatenate([[0], np.cumsum(-(-lens // CHUNK) * CHUNK)])
    d = 12 + v - 3
    d += (-d) % 8
    isect = rng.uniform(-1.0, 1.0, (d, int(starts[-1]) + CHUNK))
    for tile, (r, m) in enumerate(zip(rows, masks)):
        g[tile, :len(r)] = r
        mask[tile, :len(r)] = m
        isect[:r.shape[1], starts[tile]:starts[tile] + lens[tile]] = r[m].T

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(device)

    return EdgeCases(f32(g), f32(mask), f32(isect), i32(starts), i32(lens),
                     NTX, MAX_CHUNKS)

"""The binning decode: its inputs, its plain version and the wrapper of its
kernel (``csrc/binning_kernel.cu``).

Replaces the JAX package's Pallas ``ops/pallas/binning_kernel.py::
decode_bin_keys``.  For CPU tensors the wrapper runs the plain version
(:func:`decode_keys_plain`); for CUDA tensors it runs the kernel or
raises.  ``ops/tiles.py`` builds the inputs and sorts the result.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _min_sigma_rect(mean_u, mean_v, a, b, c, u0, u1, v0, v1):
    """Exact min of sigma(du, dv) = .5(a du^2 + c dv^2) + b du dv over the
    pixel rectangle [u0, u1] x [v0, v1].

    Zero when the centre lies inside; otherwise the minimum lies on one of
    the four edges, where the 1-D minimizer is clamped to the segment.  A
    tile whose minimum exceeds log(opac / ALPHA_CUTOFF) gets zero alpha at
    every pixel, so its (gaussian, tile) entry is spurious.  The CUDA
    kernel evaluates this in the same order of operations.
    """
    du0, du1 = u0 - mean_u, u1 - mean_u
    dv0, dv1 = v0 - mean_v, v1 - mean_v
    inside = (du0 <= 0) & (du1 >= 0) & (dv0 <= 0) & (dv1 >= 0)

    def sig(du, dv):
        return 0.5 * (a * du * du + c * dv * dv) + b * du * dv

    c_safe = torch.clamp(c, min=1e-12)
    a_safe = torch.clamp(a, min=1e-12)
    best = torch.minimum(
        torch.minimum(
            sig(du0, torch.clamp(-b * du0 / c_safe, dv0, dv1)),
            sig(du1, torch.clamp(-b * du1 / c_safe, dv0, dv1)),
        ),
        torch.minimum(
            sig(torch.clamp(-b * dv0 / a_safe, du0, du1), dv0),
            sig(torch.clamp(-b * dv1 / a_safe, du0, du1), dv1),
        ),
    )
    return torch.where(inside, torch.zeros_like(best), best)


class DecodeInputs(NamedTuple):
    """Per-gaussian fields of the run-length decode (all leading dim N)."""

    offsets: torch.Tensor  # int32 first slot of the gaussian's run
    counts: torch.Tensor   # int32 run length (0: owns no slot)
    ncols: torch.Tensor    # int32 bbox width in tiles (>= 1)
    tile0: torch.Tensor    # int32 tile id of the bbox's top-left corner
    rank: torch.Tensor     # int32 depth rank (fits in rank_bits)
    cull: torch.Tensor | None  # [N, 6] f32 (u, v, a, b, c, thresh) or None


def decode_keys_plain(d: DecodeInputs, m_cap: int, ntx: int, ts: int,
                      rank_bits: int, num_tiles: int):
    """Plain version of the decode kernel: slot -> (sort key, gid).

    The slot -> gaussian inversion scatters each gaussian's index at its
    first slot (a scatter-max) and forward-fills it with a cumulative max;
    one row gather then brings every per-gaussian field to its slots.

    Returns:
        (key [m_cap] int32, gid [m_cap] int32).
    """
    n = d.offsets.shape[0]
    dev = d.offsets.device
    ends = d.offsets.to(torch.int64) + d.counts
    total = ends[-1] if n > 0 else torch.zeros((), dtype=torch.int64,
                                                device=dev)
    seed = torch.full((m_cap + 1,), -1, dtype=torch.int64, device=dev)
    seed_pos = torch.where(d.counts > 0, d.offsets.to(torch.int64),
                           torch.full_like(ends, m_cap))
    seed.scatter_reduce_(0, seed_pos, torch.arange(n, device=dev),
                         reduce="amax")
    owner = torch.cummax(seed[:m_cap], dim=0).values
    slots = torch.arange(m_cap, device=dev)
    valid = (slots < total) & (owner >= 0)
    owner = torch.clamp(owner, 0, max(n - 1, 0))

    packed = torch.stack(
        [d.offsets, d.ncols, d.tile0, d.rank], dim=1).to(torch.int64)
    gi = packed[owner]                                          # [M, 4]
    local = slots - gi[:, 0]
    ncols = torch.clamp(gi[:, 1], min=1)
    dy = torch.div(local, ncols, rounding_mode="floor")
    dx = local - dy * ncols
    tile_id = gi[:, 2] + dy * ntx + dx
    key = (tile_id << rank_bits) | gi[:, 3]
    if d.cull is not None:
        gf = d.cull[owner]                                      # [M, 6]
        tx = (tile_id % ntx).to(torch.float32) * ts
        ty = torch.div(tile_id, ntx, rounding_mode="floor").to(
            torch.float32) * ts
        min_sig = _min_sigma_rect(gf[:, 0], gf[:, 1], gf[:, 2], gf[:, 3],
                                  gf[:, 4], tx, tx + ts, ty, ty + ts)
        valid = valid & (min_sig <= gf[:, 5])
    key = torch.where(valid, key, torch.full_like(key, num_tiles << rank_bits))
    gid = torch.where(valid, owner, torch.zeros_like(owner))
    return key.to(torch.int32), gid.to(torch.int32)


def decode_bin_keys(d: DecodeInputs, m_cap: int, ntx: int, ts: int,
                    rank_bits: int, num_tiles: int):
    """Per-slot (sort key, gid) of the intersection buffer, [m_cap] each.

    Slot s belongs to the gaussian g with offsets[g] <= s < offsets[g] +
    counts[g]; its key is ``tile << rank_bits | rank[g]``.  Slots owned by
    no gaussian, and (with ``d.cull``) slots whose tile the splat's
    alpha >= 1/255 ellipse misses, get key ``num_tiles << rank_bits`` and
    gid 0.
    """
    dev = d.offsets.device
    if dev.type == "cpu":
        return decode_keys_plain(d, m_cap, ntx, ts, rank_bits, num_tiles)
    if dev.type != "cuda":
        raise ValueError(f"decode_bin_keys: unsupported device {dev}")
    n = d.offsets.shape[0]
    ints = (d.offsets, d.counts, d.ncols, d.tile0, d.rank)
    for x in ints:
        if x.device != dev or x.dtype != torch.int32 or x.shape != (n,) \
                or not x.is_contiguous():
            raise ValueError("decode_bin_keys: per-gaussian fields must be "
                             f"contiguous int32 [{n}] on {dev}")
    if d.cull is not None and (
            d.cull.device != dev or d.cull.dtype != torch.float32
            or d.cull.shape != (n, 6) or not d.cull.is_contiguous()):
        raise ValueError("decode_bin_keys: cull must be contiguous float32 "
                         f"[{n}, 6] on {dev}")
    if not 0 < m_cap <= (1 << 30):
        raise ValueError(f"decode_bin_keys: m_cap {m_cap} out of range")
    key = torch.empty(m_cap, dtype=torch.int32, device=dev)
    gid = torch.empty(m_cap, dtype=torch.int32, device=dev)
    fn = build.entry("binning_kernel", "decode_bin_keys", *[_P] * 6,
                     *[_I] * 7, _P, _P)
    build.launch(
        "decode_bin_keys", fn, dev,
        d.offsets.data_ptr(), d.counts.data_ptr(), d.ncols.data_ptr(),
        d.tile0.data_ptr(), d.rank.data_ptr(),
        d.cull.data_ptr() if d.cull is not None else None,
        n, m_cap, ntx, ts, rank_bits, num_tiles, int(d.cull is not None),
        key.data_ptr(), gid.data_ptr())
    return key, gid

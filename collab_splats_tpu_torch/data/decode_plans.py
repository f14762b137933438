"""Seeded skewed bin plans for the binning decode.

Each plan is the decode's input (``ops/cuda/binning_kernel.py::
DecodeInputs``: run offsets, counts, bbox widths, first tiles, ranks and
the cull columns) for gaussians on a 50 x 40 grid of 16x16 tiles, with
every gaussian's count its tile bbox's area, as ``ops/tiles.py::plan_bins``
makes them.  The plans skew the run lengths in the ways a search over the
run ends finds hard:

- ``zero_runs``: runs of 3,000 and 5,000 gaussians that own no slot
  (culled or off screen), between gaussians of 1-9 slots;
- ``long_owner``: one gaussian whose bbox covers 50 x 30 tiles, so it owns
  1,500 consecutive slots, more than a merge-path block of the decode's
  kernel (``csrc/binning_kernel.cu``) takes;
- ``full``: the live total equal to the buffer's capacity.

In the first two the live total stays below the capacity, so the buffer
ends in slots owned by no gaussian.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda.binning_kernel import DecodeInputs

NTX, NTY, TS = 50, 40, 16
NUM_TILES = NTX * NTY
RANK_BITS = 31 - int(np.ceil(np.log2(NUM_TILES + 2)))
M_CAP = 16384
ALPHA_CUTOFF = 1.0 / 255.0


class Plan(NamedTuple):
    inputs: DecodeInputs
    m_cap: int
    ntx: int
    ts: int
    rank_bits: int
    num_tiles: int


def _bboxes(rng, n, max_side):
    """(ncols, nrows, tile0) of n random bboxes inside the grid."""
    ncols = rng.integers(1, max_side + 1, n)
    nrows = rng.integers(1, max_side + 1, n)
    tx0 = rng.integers(0, NTX - ncols + 1)
    ty0 = rng.integers(0, NTY - nrows + 1)
    return ncols, nrows, ty0 * NTX + tx0


def _plan(rng, ncols, nrows, tile0, live, m_cap, device) -> Plan:
    """The plan of gaussians with these bboxes, ``live`` marking those that
    own their bbox's slots; the cull columns are splats around each bbox's
    first tile, of whose (gaussian, tile) entries the cull removes 14-44%
    in these plans."""
    n = ncols.shape[0]
    counts = np.where(live, ncols * nrows, 0)
    assert counts.sum() <= m_cap
    offsets = np.cumsum(counts) - counts
    tx = tile0 % NTX * TS + rng.uniform(-20.0, TS + 20.0, n)
    ty = tile0 // NTX * TS + rng.uniform(-20.0, TS + 20.0, n)
    sx, sy = rng.uniform(1.0, 30.0, (2, n))
    rho = rng.uniform(-0.8, 0.8, n)
    ca, cb, cc = sx * sx, rho * sx * sy, sy * sy
    det = ca * cc - cb * cb
    thresh = np.log(rng.uniform(0.02, 1.0, n) / ALPHA_CUTOFF)
    cull = np.stack([tx, ty, cc / det, -cb / det, ca / det, thresh], 1)

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(device)

    inputs = DecodeInputs(
        offsets=i32(offsets), counts=i32(counts), ncols=i32(ncols),
        tile0=i32(tile0), rank=i32(rng.integers(0, 1 << RANK_BITS, n)),
        cull=torch.from_numpy(cull.astype(np.float32)).to(device))
    return Plan(inputs, m_cap, NTX, TS, RANK_BITS, NUM_TILES)


def skewed_plans(device="cpu", seed: int = 0) -> dict[str, Plan]:
    """The three skewed plans (see the module doc), on ``device``."""
    rng = np.random.default_rng(seed)
    plans = {}

    # Gaussians of 1-9 slots, with two long runs of zero-count ones.
    n = 11000
    ncols, nrows, tile0 = _bboxes(rng, n, 3)
    live = rng.uniform(size=n) < 0.6
    live[500:3500] = False
    live[6000:11000] = False
    keep = np.cumsum(np.where(live, ncols * nrows, 0)) <= M_CAP - 1000
    plans["zero_runs"] = _plan(rng, ncols, nrows, tile0, live & keep, M_CAP,
                               device)

    # One gaussian owning 1,500 consecutive slots among small ones.
    n = 2000
    ncols, nrows, tile0 = _bboxes(rng, n, 2)
    ncols[700], nrows[700], tile0[700] = NTX, 30, 5 * NTX
    live = rng.uniform(size=n) < 0.7
    live[700] = True
    counts = np.where(live, ncols * nrows, 0)
    live &= np.cumsum(counts) <= M_CAP - 300
    plans["long_owner"] = _plan(rng, ncols, nrows, tile0, live, M_CAP,
                                device)

    # Single-tile gaussians filling the buffer exactly.
    n = M_CAP + 3000
    ncols = np.ones(n, np.int64)
    nrows = np.ones(n, np.int64)
    tile0 = rng.integers(0, NUM_TILES, n)
    live = np.zeros(n, bool)
    live[rng.choice(n, M_CAP, replace=False)] = True
    plans["full"] = _plan(rng, ncols, nrows, tile0, live, M_CAP, device)
    return plans

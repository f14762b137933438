"""Each frozen count against a hand count of a tiny case."""

import pytest
import torch

import counts
from counts import (composite_batched_bwd, composite_batched_fwd,
                    decode_bin_keys, segment_sum_sorted, step)


def test_composite_fwd_by_hand():
    # 2 tiles of 4 slots, V = 6 (d = 15): rows 2*4*15, mask 2*4, maps
    # 2*256*(6 + 4) floats; 3 masked-in slots -> 768 pairs at 23, 100
    # live pairs at 11 + 12.
    nbytes, ops = composite_batched_fwd.count(2, 4, 6, 3, 100)
    assert nbytes == 4 * (120 + 8 + 5120)
    assert ops == 23 * 768 + 23 * 100


def test_composite_bwd_by_hand():
    # Rows read and written (2 * 120), mask 8, one prefix batch 2*256,
    # maps 2*256*(6 + 5); live pairs at 37 + 24.
    nbytes, ops = composite_batched_bwd.count(2, 4, 6, 3, 100)
    assert nbytes == 4 * (240 + 8 + 512 + 5632)
    assert ops == 23 * 768 + 61 * 100


def test_segsum_and_decode_by_hand():
    assert segment_sum_sorted.count(10, 3, 4) == (120 + 120 + 48, 30)
    assert decode_bin_keys.count(5, 2, 16, 9) == (20 + 80 + 128, 540)
    assert decode_bin_keys.count(5, 2, 16, 9, cull=False) == (
        20 + 32 + 128, 0)


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert counts.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_step_counts_alive_rows_only():
    a = step.train_step(10, 16, 6, 2, 4, 3, 100, 64, 590)
    b = step.train_step(20, 16, 6, 2, 4, 3, 100, 64, 590)
    assert b - a == 10 * 3 * (step.PROJECT_FWD + step.sh_fwd(16))
    assert step.sh_fwd(1) == 12
    assert step.sh_fwd(16) == 10 + 55 + 96 + 6


def test_features_count_by_hand():
    # 8x8 latents of 2 to a 4x4 main map (2 taps a pass), hidden 3, one
    # tower of 5 channels.
    dims = {"main": (5, 4, 4)}
    ops = step.features_fwd(8, 8, 2, 3, dims, "main")
    resize = 2 * 2 * (4 * 8 * 4 + 4 * 4 * 4)
    decoder = 2 * 16 * (2 * 3 + 3 * 5)
    assert ops == resize + decoder + 6 * 5 * 16


def test_pair_counts_on_the_reference_binning():
    """One splat of opacity 0.9 at a tile's centre: every pixel within
    its alpha >= 1/255 ellipse is a live pair, counted on the binning."""
    from reference import render as R

    g = torch.zeros(1, 15)
    g[0, 0:2] = torch.tensor([8.0, 8.0])        # centre of tile 0
    g[0, 2:5] = torch.tensor([0.5, 0.0, 0.5])   # sigma = r^2 / 4
    g[0, 8] = 0.9
    bins = R.Bins(torch.zeros(1, 2, dtype=torch.long),
                  torch.tensor([[True, False]]), 1, 1, 0)
    masked, live = R.pair_counts(g, bins, {"tile_size": 16})
    up = torch.arange(16) + 0.5
    r2 = (up[None, :] - 8) ** 2 + (up[:, None] - 8) ** 2
    want = int((0.9 * torch.exp(-r2 / 4) >= 1 / 255).sum())
    assert (masked, live) == (1, want)

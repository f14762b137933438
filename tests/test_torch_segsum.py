"""Parity of the port's sorted segment sum with the JAX package, on the CPU.

The plain version (``ops/cuda/segsum_kernel.py::segment_sum_plain``, which
the wrapper runs for CPU tensors) sums each id's rows exactly, in sorted
order.  It is held against the Pallas ``expand_bwd_pallas`` in interpret
mode, which sums exactly too (rtol 1e-6: the one-hot matmul adds the same
rows in another order), and against the XLA ``_expand_bwd``, whose sums
are differences of running prefixes (gradient tolerance: rtol 5e-4, atol
5e-5 * max|g|, tests/test_pallas.py:205-206).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.ops.pallas.segsum_kernel import expand_bwd_pallas
from collab_splats_tpu.ops.segsum import _expand_bwd
from collab_splats_tpu_torch.ops import segsum
from collab_splats_tpu_torch.ops.cuda import build, segsum_kernel

torch.set_num_threads(2)
N, M, D = 700, 3000, 15


def inputs(seed, n=N, m=M, d=D):
    """Ids with every multiplicity, ids that own no row, and rows of mixed
    sign and scale."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n // 2, m).astype(np.int32) * 2   # odd ids empty
    idx[: m // 10] = 6                                      # one long run
    rows = (rng.normal(size=(m, d))
            * rng.uniform(1e-3, 1e3, (m, 1))).astype(np.float32)
    return idx, rows


def port(idx, rows, n=N):
    return segsum.segment_sum(torch.from_numpy(idx), torch.from_numpy(rows),
                              n).numpy()


def test_plain_matches_pallas_exact_sums():
    idx, rows = inputs(0)
    ref = np.asarray(expand_bwd_pallas(N, jnp.asarray(idx),
                                       jnp.asarray(rows), interpret=True))
    got = port(idx, rows)
    assert got.shape == (N, D)
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def test_plain_matches_xla_prefix_differences():
    idx, rows = inputs(1)
    ref = np.asarray(_expand_bwd(N, jnp.asarray(idx), jnp.asarray(rows))[0])
    got = port(idx, rows)
    np.testing.assert_allclose(got, ref, rtol=5e-4,
                               atol=5e-5 * np.abs(ref).max())


def test_sums_in_float64_and_empty_segments():
    idx, rows = inputs(2)
    got = port(idx, rows)
    ref = np.zeros((N, D))
    np.add.at(ref, idx, rows.astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    owners = np.zeros(N, bool)
    owners[idx] = True
    assert not owners[1::2].any()
    assert np.all(got[~owners] == 0.0)


def test_two_calls_are_bitwise_equal():
    idx, rows = inputs(3)
    assert np.array_equal(port(idx, rows), port(idx, rows))


@pytest.mark.parametrize("d", [1, 2, 19])
def test_widths(d):
    idx, rows = inputs(4, d=d)
    ref = np.zeros((N, d))
    np.add.at(ref, idx, rows.astype(np.float64))
    np.testing.assert_allclose(port(idx, rows), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_expand_rows_gathers_and_reduces():
    idx, rows = inputs(5)
    table = torch.from_numpy(
        np.random.default_rng(6).normal(size=(N, D)).astype(np.float32))
    table.requires_grad_(True)
    launches = build.launches["segment_sum_sorted"]
    out = segsum.expand_rows(table, torch.from_numpy(idx))
    assert torch.equal(out, table.detach()[torch.from_numpy(idx).long()])
    out.backward(torch.from_numpy(rows))
    assert torch.equal(table.grad, torch.from_numpy(port(idx, rows)))
    # The CPU runs the plain sum.
    assert build.launches["segment_sum_sorted"] == launches


def skewed(seed, n=N, m=M, d=D):
    """Ids with a gaussian that owns a third of the rows, a run of ids that
    own none, the last id owned, and M no multiple of a block."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx = np.where((idx >= 200) & (idx < 450), idx % 200, idx)
    idx[: m // 3] = 11
    idx[-5:] = n - 1
    rows = (rng.normal(size=(m, d))
            * rng.uniform(1e-3, 1e3, (m, 1))).astype(np.float32)
    return idx, rows


@pytest.mark.parametrize("case", ["spread", "skewed", "no_rows", "all_one"])
def test_segment_starts_match_jax_searchsorted(case):
    if case == "spread":
        idx, _ = inputs(7)
    elif case == "skewed":
        idx, _ = skewed(8, m=M + 3)
    elif case == "no_rows":
        idx = np.zeros(0, np.int32)
    else:
        idx = np.full(M, N - 1, np.int32)
    sidx = np.sort(idx)
    ref = np.asarray(jnp.searchsorted(jnp.asarray(sidx),
                                      jnp.arange(N + 1, dtype=jnp.int32),
                                      side="left"))
    got = segsum_kernel.segment_starts_plain(torch.from_numpy(sidx), N)
    assert got.dtype == torch.int32 and got.shape == (N + 1,)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("d", [2, 15, 16])
def test_expand_rows_backward_on_skewed_ids_matches_pallas(d):
    idx, rows = skewed(9, d=d)
    table = torch.zeros((N, d), requires_grad=True)
    segsum.expand_rows(table, torch.from_numpy(idx)).backward(
        torch.from_numpy(rows))
    ref = np.asarray(expand_bwd_pallas(N, jnp.asarray(idx),
                                       jnp.asarray(rows), interpret=True))
    got = table.grad.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    owned = np.bincount(idx, minlength=N) > 0
    assert not owned[200:450].any() and owned[N - 1]
    assert np.all(got[~owned] == 0.0) and np.all(ref[~owned] == 0.0)


@pytest.mark.parametrize("d", [2, 15])
def test_expand_rows_backward_on_tile_length_ids_matches_pallas(d):
    """Ids as a tiled layout makes them, at most one row per tile: a few
    own more rows than ``LONG_ROWS`` (which the kernel sums with a whole
    block), the others one or two."""
    rng = np.random.default_rng(10 + d)
    tiles = segsum_kernel.LONG_ROWS + 22
    long_ids = np.array([3, 4, 350, N - 1], np.int32)
    others = np.setdiff1d(np.arange(N, dtype=np.int32), long_ids)
    idx = rng.permutation(np.concatenate([
        np.repeat(long_ids, tiles), rng.choice(others, M - 4 * tiles)]))
    rows = rng.normal(size=(M, d)).astype(np.float32)
    table = torch.zeros((N, d), requires_grad=True)
    segsum.expand_rows(table, torch.from_numpy(idx)).backward(
        torch.from_numpy(rows))
    ref = np.asarray(expand_bwd_pallas(N, jnp.asarray(idx),
                                       jnp.asarray(rows), interpret=True))
    np.testing.assert_allclose(table.grad.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    counts = np.bincount(idx, minlength=N)
    assert np.all(counts[long_ids] == tiles) and counts[others].max() < tiles


def test_spread_masked_keeps_live_ids():
    idx = torch.tensor([5, 3, 9, 1], dtype=torch.int32)
    mask = torch.tensor([True, False, True, False])
    got = segsum.spread_masked(idx, mask, 4)
    assert got.tolist() == [5, 1, 9, 3]

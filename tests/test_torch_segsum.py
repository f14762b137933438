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
from collab_splats_tpu_torch.ops.cuda import segsum_kernel

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
    launches = segsum_kernel.launches
    out = segsum.expand_rows(table, torch.from_numpy(idx))
    assert torch.equal(out, table.detach()[torch.from_numpy(idx).long()])
    out.backward(torch.from_numpy(rows))
    assert torch.equal(table.grad, torch.from_numpy(port(idx, rows)))
    assert segsum_kernel.launches == launches   # the CPU runs the plain sum


def test_spread_masked_keeps_live_ids():
    idx = torch.tensor([5, 3, 9, 1], dtype=torch.int32)
    mask = torch.tensor([True, False, True, False])
    got = segsum.spread_masked(idx, mask, 4)
    assert got.tolist() == [5, 1, 9, 3]

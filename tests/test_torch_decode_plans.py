"""The binning decode on skewed bin plans, against the JAX package, on the CPU.

The port's decode (``ops/cuda/binning_kernel.py::decode_bin_keys``, whose
plain version ``decode_keys_plain`` runs for CPU tensors) is held bit-exact
against the JAX package's Pallas ``decode_bin_keys`` in interpret mode, fed
as ``ops/tiles.py::_decode_keys_pallas`` feeds it, on the seeded plans of
``data/decode_plans.py``: long runs of zero-count gaussians, one gaussian
owning more slots than a merge-path block of the kernel, a live total below
the buffer's capacity and one equal to it; each with the ellipse cull and
without.  Keys and gids are integers and agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.ops.pallas import binning_kernel as jbk
from collab_splats_tpu_torch.data import decode_plans
from collab_splats_tpu_torch.ops.cuda import binning_kernel

torch.set_num_threads(2)
PLANS = decode_plans.skewed_plans()


def jax_decode(plan, cull):
    """JAX's Pallas decode (interpret mode) of the plan, fed its [16, N]
    column matrix and per-block gaussian windows as
    ``ops/tiles.py::_decode_keys_pallas`` builds them."""
    d = plan.inputs
    n = d.offsets.shape[0]
    offsets, counts = d.offsets.numpy(), d.counts.numpy()
    ends = offsets + counts
    rows = np.zeros((jbk.C_ROWS, n), np.float32)
    rows[jbk.C_OFF] = offsets
    rows[jbk.C_END] = ends
    rows[jbk.C_NCOLS] = d.ncols.numpy()
    rows[jbk.C_TILE0] = d.tile0.numpy()
    rows[jbk.C_RANK] = d.rank.numpy()
    rows[jbk.C_GIDX] = np.arange(n)
    rows[jbk.C_ONE] = 1.0
    if cull:
        rows[[jbk.C_MU, jbk.C_MV, jbk.C_A, jbk.C_B, jbk.C_C,
              jbk.C_THR]] = d.cull.numpy().T
    n_pad = -(-n // jbk.GW) * jbk.GW
    cols = np.pad(rows, ((0, 0), (0, n_pad - n)))
    m_blocks = -(-plan.m_cap // jbk.S_BLOCK)
    edges = np.arange(m_blocks + 1) * jbk.S_BLOCK
    raw = np.searchsorted(ends, edges, side="right")
    lo = np.clip(raw[:-1] // jbk.GW * jbk.GW, 0, n_pad - jbk.GW)
    hi = np.clip(-(-(raw[1:] + 1) // jbk.GW) * jbk.GW, 0, n_pad)
    hi = np.maximum(hi, lo + jbk.GW)
    out = np.asarray(jbk.decode_bin_keys(
        jnp.asarray(cols), jnp.asarray(lo, jnp.int32),
        jnp.asarray(hi, jnp.int32), m_blocks, plan.ntx, plan.ts,
        plan.rank_bits, plan.num_tiles, cull, True)).reshape(
            m_blocks, 8, jbk.S_BLOCK)
    return (out[:, 0].reshape(-1)[:plan.m_cap],
            out[:, 1].reshape(-1)[:plan.m_cap])


def test_plans_are_skewed():
    """Each plan has the skew its name promises."""
    for name, plan in PLANS.items():
        counts = plan.inputs.counts.numpy()
        total = int(counts.sum())
        assert (plan.m_cap == total) == (name == "full"), name
        zero = np.concatenate([[0], np.flatnonzero(counts), [len(counts)]])
        if name == "zero_runs":
            assert np.diff(zero).max() > 3000
        if name == "long_owner":
            assert counts.max() == 1500


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no-cull"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_decode_matches_jax_on_skewed_plans(name, cull):
    plan = PLANS[name]
    d = plan.inputs if cull else plan.inputs._replace(cull=None)
    args = (d, plan.m_cap, plan.ntx, plan.ts, plan.rank_bits, plan.num_tiles)
    key, gid = binning_kernel.decode_bin_keys(*args)
    ref_key, ref_gid = jax_decode(plan, cull)
    np.testing.assert_array_equal(key.numpy(), ref_key)
    np.testing.assert_array_equal(gid.numpy(), ref_gid)
    ref_plain = binning_kernel.decode_keys_plain(*args)
    assert torch.equal(key, ref_plain[0]) and torch.equal(gid, ref_plain[1])
    sentinel = plan.num_tiles << plan.rank_bits
    culled = int((key[:int(d.counts.sum())] == sentinel).sum())
    assert (culled > 0) == cull

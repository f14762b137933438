"""Parity of the port's compositing backward with the JAX package, on the CPU.

The plain backward (``core/compositing.py::fused_backward``, which the
wrapper ``ops/cuda/batched.py::composite_batched_bwd`` runs for CPU
tensors) is held against ``jax.vjp`` of the XLA ``fused_compositor`` at
V = 6 and 19, against the Pallas ``composite_batched_bwd`` in interpret
mode (through ``_pallas_fused(..., pallas_bwd=True)``), and against
``torch.autograd`` through the dense plain forward in float64.  Gradient
tolerance: rtol 5e-4 and atol 5e-5 * max|g| (tests/test_pallas.py:205-206),
since the moment recombination and the suffix scan sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.compositing import fused_compositor
from collab_splats_tpu.ops.rasterize import _pallas_fused
from collab_splats_tpu_torch.core import compositing
from collab_splats_tpu_torch.ops.cuda import batched, build
from test_torch_composite import K, NEAR, NTX, NTY, TS, window_rows

torch.set_num_threads(2)
P = TS * TS


def cotangents(v, seed):
    rng = np.random.default_rng(seed)
    t = NTX * NTY
    return [rng.normal(size=s).astype(np.float32)
            for s in ((t, P, v), (t, P), (t, P), (t, P))]


def assert_grad_close(a, b, name):
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5 * scale,
                               err_msg=name)


def plain_backward(g, mask, cots, dtype=torch.float32):
    g = torch.from_numpy(g).to(dtype)
    mask = torch.from_numpy(mask).to(dtype)
    fwd = compositing.fused_forward(g, mask, NTX, TS, NEAR)
    return compositing.fused_backward(
        g, mask, fwd[4], 1.0 - fwd[1],
        *(torch.from_numpy(c).to(dtype) for c in cots), NTX, TS, NEAR)


@pytest.mark.parametrize("v", [6, 19])
def test_plain_backward_matches_jax_vjp(v):
    g, mask = window_rows(v, seed=v)
    cots = cotangents(v, seed=10 + v)
    tid = np.arange(NTX * NTY)
    up = ((tid % NTX)[:, None] * TS + np.arange(P) % TS + 0.5)
    vp = ((tid // NTX)[:, None] * TS + np.arange(P) // TS + 0.5)
    f = fused_compositor(NEAR)
    _, vjp = jax.vjp(
        lambda gg, snk: f(gg, snk, jnp.asarray(mask),
                          jnp.asarray(up, jnp.float32),
                          jnp.asarray(vp, jnp.float32)),
        jnp.asarray(g), jnp.zeros(g.shape[:2] + (2,), jnp.float32))
    d_g_ref, d_sink_ref = vjp(tuple(jnp.asarray(c) for c in cots))
    d_g = plain_backward(g, mask, cots).numpy()
    assert d_g.shape == g.shape
    assert_grad_close(d_g, np.asarray(d_g_ref), "d_g")
    # The sink's gradient is d_g's mean columns.
    assert_grad_close(d_g[..., :2], np.asarray(d_sink_ref), "d_sink")


def test_plain_backward_matches_pallas_backward():
    g, mask = window_rows(6, seed=21)
    cots = cotangents(6, seed=22)
    f = _pallas_fused(NEAR, NTX, TS, True, NTX * NTY, pallas_bwd=True)
    sink = jnp.zeros(g.shape[:2] + (2,), jnp.float32)
    _, vjp = jax.vjp(lambda gg: f(gg, sink, jnp.asarray(mask)),
                     jnp.asarray(g))
    (d_g_ref,) = vjp(tuple(jnp.asarray(c) for c in cots))
    assert_grad_close(plain_backward(g, mask, cots).numpy(),
                      np.asarray(d_g_ref), "d_g")


def test_plain_backward_matches_float64_autograd():
    """Away from median switches the forward is smooth in g, so autograd
    through the dense plain forward gives the exact vjp; in float64 the
    moment form agrees with it to ~1e-9."""
    g, mask = window_rows(6, seed=31)
    cots = cotangents(6, seed=32)
    g64 = torch.from_numpy(g).double().requires_grad_(True)
    out = compositing.fused_forward(g64, torch.from_numpy(mask).double(),
                                    NTX, TS, NEAR, tile_chunk=8)
    ref = torch.autograd.grad(
        out[:4], g64, [torch.from_numpy(c).double() for c in cots])[0]
    got = plain_backward(g, mask, cots, dtype=torch.float64)
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=1e-7, atol=1e-9 * scale)


def test_masked_slots_get_exactly_zero():
    g, mask = window_rows(19, seed=41)
    d_g = plain_backward(g, mask, cotangents(19, seed=42)).numpy()
    assert np.abs(d_g[mask == 0]).max() == 0.0
    assert np.abs(d_g[mask > 0]).max() > 0.0


def test_banked_prefix_is_the_carry_in_front_of_each_batch():
    g, mask = window_rows(6, seed=51)
    gt, mt = torch.from_numpy(g), torch.from_numpy(mask)
    fwd = compositing.fused_forward(gt, mt, NTX, TS, NEAR, tile_chunk=8,
                                    bank_prefix=True)
    prefix = fwd[5].numpy()
    nb = -(-K // compositing.PREFIX_BATCH)
    assert prefix.shape == (nb, NTX * NTY, P)
    assert np.all(prefix[0] == 0.0)
    # The carry in front of batch b is the log-transmittance of the slots
    # before it: log(1 - alpha) summed in float64.
    up, vp = compositing.pixel_centers(torch.arange(NTX * NTY), NTX, TS)
    alpha = compositing._chain(gt, mt, up, vp, NEAR).alpha.double()
    log1m = torch.log1p(-alpha)
    for b in range(1, nb):
        ref = log1m[..., :b * compositing.PREFIX_BATCH].sum(-1).numpy()
        np.testing.assert_allclose(prefix[b], ref, rtol=1e-5, atol=1e-5)
    # Without the flag nothing more is returned.
    assert len(compositing.fused_forward(gt, mt, NTX, TS, NEAR)) == 5


def test_composite_backward_runs_plain_version_on_cpu():
    g, mask = window_rows(6, seed=61)
    cots = cotangents(6, seed=62)
    names = ("composite_batched_fwd", "composite_batched_bwd")
    launches = [build.launches[k] for k in names]
    gt = torch.from_numpy(g).requires_grad_(True)
    out = batched.composite(gt, torch.from_numpy(mask), NTX, TS, NEAR)
    torch.autograd.backward(out[:4], [torch.from_numpy(c) for c in cots])
    assert [build.launches[k] for k in names] == launches
    assert torch.equal(gt.grad, plain_backward(g, mask, cots))


def test_missing_cotangents_count_as_zeros():
    g, mask = window_rows(6, seed=71)
    cots = cotangents(6, seed=72)
    gt = torch.from_numpy(g).requires_grad_(True)
    out = batched.composite(gt, torch.from_numpy(mask), NTX, TS, NEAR)
    (out[1] * torch.from_numpy(cots[1])).sum().backward()
    zero = [np.zeros_like(c) for c in cots]
    ref = plain_backward(g, mask, [zero[0], cots[1], zero[2], zero[3]])
    assert torch.equal(gt.grad, ref)

"""Parity of the port's compositor with both JAX compositors, on the CPU.

The plain version (``core/compositing.py::fused_forward``, which the
wrapper ``ops/cuda/batched.py`` runs for CPU tensors) is held against the
forward of JAX's XLA ``fused_compositor`` and against the Pallas
``composite_batched_fwd`` in interpret mode, at V = 6 (normal ++ RGB) and
V = 19 (normal ++ RGB ++ 13 latents).  Tolerance rtol = atol = 1e-5, the
tolerance the two JAX compositors hold to each other
(tests/test_pallas.py::TestBatchedCompositor).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.compositing import fused_compositor
from collab_splats_tpu.ops.pallas.batched import composite_batched_fwd
from collab_splats_tpu_torch.core.compositing import fused_forward
from collab_splats_tpu_torch.ops.cuda import batched, build

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
NTX, NTY, TS, K = 8, 4, 16, 128
NEAR = 0.01


def window_rows(v, seed):
    """g [T, K, 9 + v] and mask [T, K]: random anisotropic splats around
    each tile, front to back, with live prefixes of every length (an empty
    tile and a full one included)."""
    rng = np.random.default_rng(seed)
    t = NTX * NTY
    tid = np.arange(t)
    u0 = (tid % NTX * TS)[:, None]
    v0 = (tid // NTX * TS)[:, None]
    sx = rng.uniform(1.0, 9.0, (t, K))
    sy = rng.uniform(1.0, 9.0, (t, K))
    rho = rng.uniform(-0.8, 0.8, (t, K))
    ca, cb, cc = sx * sx + 0.3, rho * sx * sy, sy * sy + 0.3
    det = ca * cc - cb * cb
    g = np.concatenate([
        np.stack([u0 + rng.uniform(-10, 26, (t, K)),
                  v0 + rng.uniform(-10, 26, (t, K)),
                  cc / det, -cb / det, ca / det,
                  np.sort(rng.uniform(0.5, 6.0, (t, K)), axis=1),
                  rng.uniform(-0.05, 0.05, (t, K)),
                  rng.uniform(-0.05, 0.05, (t, K)),
                  rng.uniform(0.02, 0.999, (t, K))], axis=-1),
        rng.uniform(-1.0, 1.0, (t, K, v)),
    ], axis=-1).astype(np.float32)
    lens = rng.integers(0, K + 1, t)
    lens[0], lens[1] = 0, K
    mask = (np.arange(K)[None, :] < lens[:, None]).astype(np.float32)
    return g, mask


def jax_fused(g, mask):
    tid = np.arange(g.shape[0])
    p = np.arange(TS * TS)
    up = ((tid % NTX)[:, None] * TS + p % TS + 0.5).astype(np.float32)
    vp = ((tid // NTX)[:, None] * TS + p // TS + 0.5).astype(np.float32)
    out = fused_compositor(NEAR)(
        jnp.asarray(g), jnp.zeros(g.shape[:2] + (2,), jnp.float32),
        jnp.asarray(mask), jnp.asarray(up), jnp.asarray(vp))
    return [np.asarray(x) for x in out]


def jax_pallas(g, mask):
    out_vt, alpha, depth, median, idx, _ = composite_batched_fwd(
        jnp.moveaxis(jnp.asarray(g[..., :9]), -1, 0),
        jnp.moveaxis(jnp.asarray(g[..., 9:]), -1, 0),
        jnp.asarray(mask), ntx=NTX, ts=TS, near_plane=NEAR, interpret=True)
    return [np.moveaxis(np.asarray(out_vt), 0, -1), np.asarray(alpha),
            np.asarray(depth), np.asarray(median), np.asarray(idx)]


@pytest.mark.parametrize("v", [6, 19])
def test_plain_compositor_matches_both_jax_compositors(v):
    g, mask = window_rows(v, seed=v)
    got = fused_forward(torch.from_numpy(g), torch.from_numpy(mask), NTX, TS,
                        NEAR, tile_chunk=8)
    names = ("out_v", "alpha", "depth_acc", "median")
    alpha = got[1].numpy()
    assert got[0].shape == (NTX * NTY, TS * TS, v)
    assert 0.0 == alpha[0].max() and alpha[1].min() > 0.5
    for ref in (jax_fused(g, mask), jax_pallas(g, mask)):
        for name, a, b in zip(names, got, ref):
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)
    # The median's slot: the Pallas kernel's index, wherever alpha > 0.
    idx_ref = jax_pallas(g, mask)[4]
    hit = alpha > 0
    np.testing.assert_array_equal(got[4].numpy()[hit], idx_ref[hit])


def test_wrapper_runs_plain_version_on_cpu():
    g, mask = window_rows(6, seed=1)
    launches = build.launches["composite_batched_fwd"]
    got = batched.composite(torch.from_numpy(g), torch.from_numpy(mask),
                            NTX, TS, NEAR)
    ref = fused_forward(torch.from_numpy(g), torch.from_numpy(mask), NTX, TS,
                        NEAR)
    assert build.launches["composite_batched_fwd"] == launches
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_compositor_refuses_gradients():
    """Gradients reach the window rows only: the mask and the median slot
    index are not differentiable."""
    g, mask = window_rows(6, seed=2)
    g = torch.from_numpy(g).requires_grad_(True)
    mask = torch.from_numpy(mask).requires_grad_(True)
    out = batched.composite(g, mask, NTX, TS, NEAR)
    assert not out[4].requires_grad
    out[0].sum().backward()
    assert mask.grad is None
    assert torch.isfinite(g.grad).all() and g.grad.abs().max() > 0


def test_chunking_does_not_change_results():
    g, mask = window_rows(19, seed=3)
    a = fused_forward(torch.from_numpy(g), torch.from_numpy(mask), NTX, TS,
                      NEAR, tile_chunk=5)
    b = fused_forward(torch.from_numpy(g), torch.from_numpy(mask), NTX, TS,
                      NEAR, tile_chunk=64)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)

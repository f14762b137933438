"""The compositing kernels' exact cull, and both compositors' plain versions
on seeded edge cases, against the JAX package on the CPU.

``core/compositing.py::sigma_cut`` is the cull that kernels 2 and 6 run
ahead of exp: a hypothesis test holds that no pair ``splat_alpha`` keeps
lies beyond it, for opacities over [1e-4, 1] and sigma within a few ulps
of the cut and around the clamp at 50.  Another holds that no such pair
lies outside the box of ``sigma_cut_extent``, by which kernel 6 skips a
slot in the warps it cannot reach.

``data/compositing_cases.py::edge_cases`` (the inputs ``chip_smoke.py``
also feeds the kernels) holds a pixel that never crosses 1/2 with tied
maximum weights in two chunks, segments of 1, 63, 64, 65, 127 and 129
slots, a chunk whose second batch is all dead, a tile that ends early,
and masked-out window slots between live ones.  On them:

- the batched plain version (``fused_forward`` / ``fused_backward``)
  against the XLA ``fused_compositor`` (forward and ``jax.vjp``) and the
  Pallas ``composite_batched_fwd`` in interpret mode, at V = 6 and 19;
- the per-tile plain version (``composite_tiles_fwd_plain`` /
  ``composite_tiles_bwd_plain``) against the Pallas
  ``composite_tiles_fwd`` and ``composite_tiles_bwd_call`` in interpret
  mode, at C = 3 and 16, stop 0 and 1e-4, with the forward's ``nchunks``
  and with ``nchunks`` below the segments' walk.

Tolerances: maps rtol = atol = 1e-5, integers exactly, gradients rtol 5e-4
and atol 5e-5 * max|g| per group (tests/test_pallas.py:205-206).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from collab_splats_tpu.core.compositing import fused_compositor
from collab_splats_tpu.ops.pallas import composite as jcomposite
from collab_splats_tpu.ops.pallas.batched import composite_batched_fwd
from collab_splats_tpu_torch.core import compositing
from collab_splats_tpu_torch.data import compositing_cases as cases
from collab_splats_tpu_torch.ops.cuda import composite

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
TS, NEAR = cases.TS, 0.01
P = TS * TS
T = cases.NTX * cases.NTY
TX, TY = cases.TIE_PIXEL
TIE_PIX = TY * TS + TX


def assert_grad_close(a, b, name):
    scale = np.abs(b).max()
    assert scale > 0, name
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5 * scale,
                               err_msg=name)


# ------------------------------------------------------------ the cull
def _ulps(x, n):
    """float32 x moved by n ulps (x > 0)."""
    bits = np.float32(x).view(np.int32) + np.int32(n)
    return float(bits.view(np.float32))


@settings(max_examples=300, deadline=None)
@given(opac=st.floats(float(np.float32(1e-4)), 1.0, width=32),
       shift=st.integers(-8, 8),
       offset=st.floats(-float(np.float32(0.01)), float(np.float32(0.01)),
                        width=32),
       at_clamp=st.booleans())
def test_no_kept_pair_lies_beyond_sigma_cut(opac, shift, offset, at_clamp):
    cut = float(compositing.sigma_cut(torch.tensor([opac]))[0])
    # sigma a few ulps from the cut (or from the clamp at 50), and within
    # 0.01 of it, which spans the margin-free ln(255 opac).
    centre = 50.0 if at_clamp or cut == float("inf") else cut
    sigmas = ([_ulps(centre, shift), centre + offset] if centre > 0
              else [0.0, abs(offset)])
    # Pixel offsets du whose quadratic form under the identity conic,
    # 0.5 du du, is (close to) sigma.
    du = torch.sqrt(2.0 * torch.tensor(sigmas, dtype=torch.float32))
    sigma = 0.5 * (du * du)
    conic = torch.tensor([1.0, 0.0, 1.0]).expand(len(sigmas), 3)
    alpha = compositing.splat_alpha(du, torch.zeros_like(du), conic,
                                    torch.full_like(du, opac),
                                    torch.ones_like(du, dtype=torch.bool))
    beyond = sigma > compositing.sigma_cut(torch.full_like(du, opac))
    assert not bool((beyond & (alpha > 0)).any()), (opac, sigma, alpha)


@settings(max_examples=300, deadline=None)
@given(scale=st.floats(0.05, 30.0), aspect=st.floats(1.0, 200.0),
       theta=st.floats(0.0, 3.2), opac=st.floats(0.005, 1.0),
       seed=st.integers(0, 2 ** 16))
def test_every_live_pair_lies_in_its_box(scale, aspect, theta, opac, seed):
    """No pair splat_alpha keeps lies outside sigma_cut_extent's box, for
    splats from round to 200:1 (past the box's 1e4 conditioning bound,
    where it must give way) at any angle, at pixel offsets spread over
    and just past the box's edge."""
    s1, s2 = scale, scale / aspect
    cs, sn = np.cos(theta), np.sin(theta)
    cov = np.array([[cs, -sn], [sn, cs]]) @ np.diag([s1 * s1, s2 * s2]) \
        @ np.array([[cs, sn], [-sn, cs]])
    inv = np.linalg.inv(cov)
    conic = torch.tensor([[inv[0, 0], inv[0, 1], inv[1, 1]]],
                         dtype=torch.float32)
    op = torch.tensor([opac], dtype=torch.float32)
    cut = compositing.sigma_cut(op)
    eu, ev = compositing.sigma_cut_extent(conic, cut)
    rng = np.random.default_rng(seed)
    span = [x if np.isfinite(x) and x > 0 else 3.0 * scale
            for x in (float(eu[0]), float(ev[0]))]
    d = rng.uniform(-1.2, 1.2, (4096, 2)) * span
    du = torch.tensor(d[:, 0], dtype=torch.float32)
    dv = torch.tensor(d[:, 1], dtype=torch.float32)
    alpha = compositing.splat_alpha(du, dv, conic.expand(4096, 3),
                                    op.expand(4096),
                                    torch.ones(4096, dtype=torch.bool))
    live = alpha > 0
    inside = (du.double().abs() <= eu) & (dv.double().abs() <= ev)
    assert not bool((live & ~inside).any())


def test_sigma_cut_is_inf_from_the_clamp_and_culls_below_it():
    cut = compositing.sigma_cut(torch.tensor([0.0, 1e-4, 0.5, 1.0, 1e30,
                                              float("nan")]))
    assert cut[0] == -float("inf") and cut[1] < 0.0
    assert 4.8 < float(cut[2]) < float(cut[3]) < 5.6
    assert cut[4] == float("inf") and cut[5] == float("inf")


def test_sigma_cut_keeps_every_live_pair_of_the_edge_cases():
    e = cases.edge_cases(6)
    ch = compositing._chain(e.g, e.mask, *compositing.pixel_centers(
        torch.arange(T), e.ntx, TS), NEAR)
    cut = compositing.sigma_cut(e.g[..., 8])[:, None, :]
    assert bool(ch.keep.any())
    assert not bool((ch.keep & (ch.sigma > cut)).any())


# --------------------------------------------------- the batched compositor
@pytest.fixture(scope="module", params=[6, 19], ids=["V6", "V19"])
def window(request):
    v = request.param
    e = cases.edge_cases(v)
    return v, e.g.numpy(), e.mask.numpy()


def _pixel_grid():
    tid = np.arange(T)
    up = ((tid % cases.NTX)[:, None] * TS + np.arange(P) % TS + 0.5)
    vp = ((tid // cases.NTX)[:, None] * TS + np.arange(P) // TS + 0.5)
    return jnp.asarray(up, jnp.float32), jnp.asarray(vp, jnp.float32)


def test_window_cases_forward_matches_jax(window):
    v, g, mask = window
    got = compositing.fused_forward(torch.from_numpy(g),
                                    torch.from_numpy(mask), cases.NTX, TS,
                                    NEAR, bank_prefix=True)
    ref_xla = fused_compositor(NEAR)(
        jnp.asarray(g), jnp.zeros(g.shape[:2] + (2,), jnp.float32),
        jnp.asarray(mask), *_pixel_grid())
    ref_pallas = composite_batched_fwd(
        jnp.moveaxis(jnp.asarray(g[..., :9]), -1, 0),
        jnp.moveaxis(jnp.asarray(g[..., 9:]), -1, 0), jnp.asarray(mask),
        ntx=cases.NTX, ts=TS, near_plane=NEAR, interpret=True)
    ref_pallas = [np.moveaxis(np.asarray(ref_pallas[0]), 0, -1)] + [
        np.asarray(x) for x in ref_pallas[1:5]]
    for ref in (ref_xla, ref_pallas):
        for name, a, b in zip(("out_v", "alpha", "depth", "median"), got,
                              ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=name, **TOL)
    alpha = got[1].numpy()
    hit = alpha > 0
    np.testing.assert_array_equal(got[4].numpy()[hit], ref_pallas[4][hit])
    # The tie pixel never crosses 1/2 and keeps the first tied slot.
    tie = cases.TIE_TILES[0]
    assert 0 < alpha[tie, TIE_PIX] < 0.5
    assert int(got[4][tie, TIE_PIX]) == cases.TIE_SLOTS[0]
    # The masked-out slots between live ones add nothing; the banked carry
    # in front of each batch is the carry the median pass saw.
    assert alpha[cases.HOLE_TILE].max() > 0
    np.testing.assert_array_equal(got[5][0].numpy(), 0.0)


def test_window_cases_backward_matches_jax_vjp(window):
    v, g, mask = window
    rng = np.random.default_rng(v)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((T, P, v), (T, P), (T, P), (T, P))]
    f = fused_compositor(NEAR)
    _, vjp = jax.vjp(lambda gg: f(gg, jnp.zeros(g.shape[:2] + (2,)),
                                  jnp.asarray(mask), *_pixel_grid()),
                     jnp.asarray(g))
    (ref,) = vjp(tuple(jnp.asarray(c) for c in cots))
    tg, tm = torch.from_numpy(g), torch.from_numpy(mask)
    fwd = compositing.fused_forward(tg, tm, cases.NTX, TS, NEAR)
    got = compositing.fused_backward(
        tg, tm, fwd[4], 1.0 - fwd[1], *(torch.from_numpy(c) for c in cots),
        cases.NTX, TS, NEAR).numpy()
    ref = np.asarray(ref)
    for name, a, b in (("mean", 0, 2), ("conic", 2, 5), ("depth", 5, 8),
                       ("opacity", 8, 9), ("vals", 9, None)):
        assert_grad_close(got[..., a:b], ref[..., a:b], name)
    assert not got[mask == 0].any()


# --------------------------------------------------- the per-tile compositor
@pytest.fixture(scope="module", params=[(3, 0.0), (3, 1e-4), (16, 1e-4)],
                ids=["C3-stop0", "C3-stop1e-4", "C16-stop1e-4"])
def tiles_fwd(request):
    n_color, stop = request.param
    e = cases.edge_cases(n_color + 3)
    args = (e.isect, e.starts, e.lens, e.ntx, TS, n_color, NEAR, stop,
            e.max_chunks)
    got, nch = composite.composite_tiles_fwd_plain(*args)
    ref, ref_n = jcomposite.composite_tiles_fwd(
        *(jnp.asarray(x.numpy()) for x in args[:3]), e.ntx, TS, n_color,
        near_plane=NEAR, stop_threshold=stop, max_chunks=e.max_chunks,
        interpret=True)
    return n_color, stop, e, (got, nch), (np.asarray(ref), np.asarray(ref_n))


def test_tile_cases_forward_matches_jax(tiles_fwd):
    n_color, stop, e, (got, nch), (ref, ref_n) = tiles_fwd
    np.testing.assert_array_equal(nch.numpy(), ref_n)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    walk = np.minimum(-(-e.lens.numpy() // cases.CHUNK), e.max_chunks)
    if stop > 0:
        assert nch[cases.OPAQUE_TILE] < walk[cases.OPAQUE_TILE]
    else:
        np.testing.assert_array_equal(nch.numpy(), walk)
    # The tie pixel never crosses 1/2; its median is the first tied slot's
    # depth (2.0, the second's is 3.0).
    tie = got[cases.TIE_TILES[1], TIE_PIX]
    assert 0 < float(tie[n_color + 3]) < 0.5
    assert float(tie[n_color + 5]) == 2.0


@pytest.mark.parametrize("below", [False, True],
                         ids=["forward-nchunks", "nchunks-below-walk"])
def test_tile_cases_backward_matches_jax(tiles_fwd, below):
    n_color, _, e, (_, nch), _ = tiles_fwd
    if below:   # one chunk fewer than the forward ran, where it ran any
        nch = torch.clamp(nch - 1, min=0)
    g = torch.from_numpy(np.random.default_rng(n_color).normal(
        size=(T, P, n_color + 6)).astype(np.float32))
    args = (e.isect, e.starts, e.lens, e.ntx, nch, g, TS, n_color, NEAR,
            e.max_chunks)
    got = composite.composite_tiles_bwd_plain(*args).numpy()
    ref = np.asarray(jcomposite.composite_tiles_bwd_call(
        *(jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
          for a in args), interpret=True))
    rows = 12 + n_color
    for name, a, b in (("mean", 0, 2), ("conic", 2, 5), ("depth", 5, 8),
                       ("opacity", 8, 9), ("normal", 9, 12),
                       ("colour", 12, rows)):
        assert_grad_close(got[a:b], ref[a:b], name)
    assert not got[rows:].any()
    # The median's cotangent reaches the first tied slot only: the two
    # slots are live at the tie pixel alone, with equal weights.
    tie = cases.TIE_TILES[1]
    col = int(e.starts[tie]) + np.array(cases.TIE_SLOTS)
    if int(nch[tie]) == 2:
        g_med = float(g[tie, TIE_PIX, n_color + 5])
        np.testing.assert_allclose(got[5, col[0]] - g_med, got[5, col[1]],
                                   rtol=1e-5, atol=1e-6)

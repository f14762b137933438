"""The SH colour op (``ops/cuda/sh_colors.py``) and its plain versions:
``core/sh.py::eval_sh_colors_backward`` against autograd of
``eval_sh_colors`` at K = 4, 9 and 16 bases and every active degree, with
rows whose colour clamps at 0 and bases masked to exact zeros; the op on
the CPU against the JAX package's ``eval_sh`` + clamp and ``jax.grad``;
the camera centre's gradient; the counters of ``compute_colors`` off the
card; and, on a card, the kernels against the plain versions."""

import numpy as np
import pytest
import torch

from collab_splats_tpu_torch.core import sh
from collab_splats_tpu_torch.core.cameras import camera_from_numpy
from collab_splats_tpu_torch.data.synthetic import look_at_c2w
from collab_splats_tpu_torch.models import rade_gs
from collab_splats_tpu_torch.ops.cuda import sh_colors as op
from collab_splats_tpu_torch.utils import profiling

torch.set_num_threads(2)
N = 700
# Gradients: the north star's rtol 5e-4 and atol 5e-5 * max|g|.
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
CASES = [(k, d) for k in (4, 9, 16) for d in range(int(round(k ** 0.5)))]
CASE_IDS = [f"K{k}-degree{d}" for k, d in CASES]


def inputs(k, seed, n=N):
    """Seeded numpy rows (dc, rest, means), a centre and a cotangent; the
    dc term puts about a third of the colours below the clamp."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 2.0, (n, 3)),
            rng.normal(0.0, 0.5, (n, k - 1, 3)),
            rng.uniform(-2.0, 2.0, (n, 3)),
            rng.uniform(-1.0, 1.0, 3),
            rng.normal(0.0, 1.0, (n, 3)))


def torch_inputs(k, seed, dtype=torch.float32, device="cpu", n=N):
    return [torch.tensor(x, dtype=dtype, device=device)
            for x in inputs(k, seed, n)]


def assert_grad_close(got, ref, what):
    np.testing.assert_allclose(
        got, ref, rtol=GRAD_RTOL,
        atol=GRAD_ATOL * float(np.abs(ref).max()), err_msg=what)


def autograd_of_plain(dc, rest, means, center, degree, g, wrt=4):
    """Colours and autograd's gradients of ``eval_sh_colors`` with respect
    to the first ``wrt`` of (dc, rest, means, center)."""
    xs = [x.clone().requires_grad_(i < wrt)
          for i, x in enumerate((dc, rest, means, center))]
    out = sh.eval_sh_colors(*xs, degree)
    return out.detach(), torch.autograd.grad(out, xs[:wrt], g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,degree", CASES, ids=CASE_IDS)
def test_plain_backward_matches_autograd(k, degree, dtype):
    dc, rest, means, center, g = torch_inputs(k, 10 * k + degree, dtype)
    out, ref = autograd_of_plain(dc, rest, means, center, degree, g, wrt=3)
    clamped = float((out == 0).double().mean())
    assert 0.1 < clamped < 0.6, clamped
    got = sh.eval_sh_colors_backward(dc, rest, means, center, degree, g)
    active = sh.num_sh_bases(degree)
    # Bases above the active degree take exact zeros.
    assert not got[1][:, active - 1:].any()
    for name, a, r in zip(("dc", "rest", "means"), got, ref):
        assert torch.isfinite(a).all(), name
        if dtype == torch.float64:
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-9,
                                       atol=1e-9 * float(r.abs().max()),
                                       err_msg=name)
        else:
            assert_grad_close(a.numpy(), r.numpy(), name)


@pytest.mark.parametrize("k,degree", CASES, ids=CASE_IDS)
def test_op_on_cpu_matches_jax(k, degree):
    import jax
    import jax.numpy as jnp

    from collab_splats_tpu.core import sh as jsh

    dc, rest, means, center, g = inputs(k, 100 + 10 * k + degree)
    f32 = [np.asarray(x, np.float32) for x in (dc, rest, means, center, g)]

    def colours(dc, rest, means):
        coeffs = jnp.concatenate([dc[:, None, :], rest], axis=1)
        rgb = jsh.eval_sh(coeffs, means - f32[3][None, :], degree)
        return jnp.maximum(rgb + 0.5, 0.0)

    ref = np.asarray(colours(*f32[:3]))
    ref_g = jax.grad(lambda *a: jnp.sum(colours(*a) * f32[4]),
                     argnums=(0, 1, 2))(*f32[:3])
    xs = [torch.tensor(x).requires_grad_(i < 3) for i, x in enumerate(f32[:4])]
    out = op.sh_colors(*xs, degree)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref).max()))
    got = torch.autograd.grad(out, xs[:3], torch.tensor(f32[4]))
    for name, a, r in zip(("dc", "rest", "means"), got, ref_g):
        assert_grad_close(a.numpy(), np.asarray(r), name)


@pytest.mark.parametrize("k", [4, 9, 16])
def test_op_camera_center_gradient_matches_autograd(k):
    """A centre that requires grad (pose optimisation) takes minus the sum
    of the means' gradients, and the rows' gradients are unchanged."""
    degree = int(round(k ** 0.5)) - 1
    dc, rest, means, center, g = torch_inputs(k, 200 + k)
    _, ref = autograd_of_plain(dc, rest, means, center, degree, g)
    xs = [x.clone().requires_grad_(True) for x in (dc, rest, means, center)]
    got = torch.autograd.grad(op.sh_colors(*xs, degree), xs, g)
    for name, a, r in zip(("dc", "rest", "means", "center"), got, ref):
        assert_grad_close(a.numpy(), r.numpy(), name)


def test_op_gradients_only_where_asked():
    """Only the centre asks: the means' gradient is computed for it and
    not returned; only dc asks: nothing else is."""
    dc, rest, means, center, g = torch_inputs(16, 300)
    _, ref = autograd_of_plain(dc, rest, means, center, 3, g)
    c = center.clone().requires_grad_(True)
    out = op.sh_colors(dc, rest, means, c, 3)
    (g_c,) = torch.autograd.grad(out, [c], g)
    assert_grad_close(g_c.numpy(), ref[3].numpy(), "center")
    d = dc.clone().requires_grad_(True)
    (g_d,) = torch.autograd.grad(op.sh_colors(d, rest, means, center, 3),
                                 [d], g)
    assert_grad_close(g_d.numpy(), ref[0].numpy(), "dc")
    assert op.sh_bwd(dc, rest, means, center, 3, g,
                     (True, False, False))[1:] == (None, None)


def _camera(center):
    c2w = look_at_c2w(np.asarray(center, np.float64), np.zeros(3))
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)
    return camera_from_numpy(K, c2w.astype(np.float32), 64, 48,
                             device="cpu")


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_sh_counters_off_the_card(sh_degree):
    k = sh.num_sh_bases(sh_degree)
    dc, rest, means, _, _ = torch_inputs(max(k, 4), 400)
    params = {"features_dc": dc, "features_rest": rest[:, :k - 1],
              "means": means}
    cam = _camera([3.0, 0.5, 1.0])
    cfg = rade_gs.RadeGSConfig(sh_degree=sh_degree, sh_degree_interval=1)
    profiling.reset()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = rade_gs.compute_colors(params, cam, 5, cfg)
    c = profiling.totals()["counters"]
    profiling.reset()
    if sh_degree:
        assert c["render.sh_rows"] == N
        assert c["render.sh_fused_rows"] == 0
        ref = sh.eval_sh_colors(dc, rest, means, cam.camera_center(), 3)
        assert torch.equal(got, ref)
    else:
        assert "render.sh_rows" not in c and "render.sh_fused_rows" not in c
        assert torch.equal(got, torch.sigmoid(dc))


def _close(got, ref, rtol):
    """max |got - ref| over max |ref| is at most ``rtol``."""
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)) \
        <= rtol


@pytest.mark.card
def test_kernels_match_the_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    n = 200_003   # the last block ragged, its rest span not whole quads
    for k, degree in CASES:
        dc, rest, means, center, g = torch_inputs(k, 500 + k + degree,
                                                  device=dev, n=n)
        # The centre as a column of c2w (stride 4), the cotangent as a
        # slice of a wider matrix, as the trainer hands them over.
        c2w = torch.zeros((4, 4), device=dev)
        c2w[:3, 3] = center
        center = c2w[:3, 3]
        g = torch.cat([g, torch.ones((n, 5), device=dev)], dim=1)[:, :3]
        got = op.sh_fwd(dc, rest, means, center, degree)
        assert torch.equal(got, op.sh_fwd(dc, rest, means, center, degree))
        ref = sh.eval_sh_colors(dc, rest, means, center, degree)
        assert _close(got, ref, 1e-6), (k, degree)
        g_got = op.sh_bwd(dc, rest, means, center, degree, g)
        again = op.sh_bwd(dc, rest, means, center, degree, g)
        assert all(torch.equal(a, b) for a, b in zip(g_got, again))
        # Rows whose shifted colour lies within rounding of the clamp may
        # take the other side in the two versions: hold the others.
        dc64, rest64, means64, center64 = (x.double() for x in
                                           (dc, rest, means, center))
        shifted = sh.eval_sh(torch.cat([dc64[:, None], rest64], dim=1),
                             means64 - center64, degree) + 0.5
        far = (shifted.abs() > 1e-4).all(-1)
        g_ref = sh.eval_sh_colors_backward(dc64, rest64, means64, center64,
                                           degree, g.double())
        active = sh.num_sh_bases(degree)
        assert not g_got[1][:, active - 1:].any()
        for name, a, r in zip(("dc", "rest", "means"), g_got, g_ref):
            r = r[far].float()
            torch.testing.assert_close(
                a[far], r, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * float(r.abs().max()),
                msg=f"K={k}, degree {degree}: {name}")
        only = op.sh_bwd(dc, rest, means, center, degree, g,
                         (False, False, True))
        assert only[:2] == (None, None) and torch.equal(only[2], g_got[2])
    # A table whose first row is not 16-byte aligned (a shard's view):
    # the kernels refuse it, the op copies it.
    dc, rest, means, center, _ = torch_inputs(16, 600, device=dev, n=n + 1)
    view = rest[1:]
    with pytest.raises(ValueError, match="aligned"):
        op.sh_fwd(dc[1:], view, means[1:], center, 3)
    got = op.sh_colors(dc[1:], view, means[1:], center, 3)
    assert torch.equal(got, op.sh_fwd(dc[1:], view.clone(), means[1:],
                                      center, 3))

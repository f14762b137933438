"""Parity of the port's ``backend="pallas"`` render with the JAX package's,
on the CPU.

One numpy scene (400 Gaussians at 48x48, 60 of them large and opaque near
the centre, ``tile_capacity`` 256 so that segments span two chunks, the
centre tile's spills past them and exits early at ``stop_threshold``
1e-4) goes through ``ops/rasterize.py::render_tiled_pallas`` of both
packages, JAX's in interpret mode as tests/test_pallas.py runs it.  Held:
the maps within rtol = atol = 1e-5 (depth, normalized by alpha, atol 1e-4)
and ``spilled`` exactly, at C = 3 and 16 colour channels; the gradients of
the tests/test_pallas.py:87-100 loss with respect to every parameter and
the per-intersection sink within rtol 5e-4 and atol 5e-5 * max|g|
(tests/test_pallas.py:205-206); and ``update_state_from_isect`` on those
sink gradients against JAX's.  The render builds no packed
per-intersection matrix (its compositor reads the rows through the aligned
ids), and ``pack_intersections`` is that gather at every real slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.options import RenderOptions as JOpts
from collab_splats_tpu.core.sh import sh0_to_rgb as jsh0
from collab_splats_tpu.ops import rasterize as jrast
from collab_splats_tpu.train import strategy as jstrategy
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.core.sh import sh0_to_rgb as tsh0
from collab_splats_tpu_torch.data.synthetic import look_at_c2w
from collab_splats_tpu_torch.ops import rasterize as trast
from collab_splats_tpu_torch.ops.cuda import composite
from collab_splats_tpu_torch.train import strategy as tstrategy
from test_torch_core import both_cameras

torch.set_num_threads(2)
N, NBIG, SIZE = 400, 60, 48
OPTS = dict(tile_capacity=256, max_intersections=1 << 14)
TOL = dict(rtol=1e-5, atol=1e-5)
MAPS = ("color", "alpha", "normal", "median_depth", "depth")
NAMES = ("means", "scales", "quats", "opacities", "features_dc")


def scene(n_color):
    """Raw numpy parameters (log scales, opacity logits, SH dc), the extra
    colour channels and an orbit camera."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(N, 4))
    scales = rng.uniform(0.03, 0.12, (N, 3))
    scales[:NBIG] = rng.uniform(0.15, 0.3, (NBIG, 3))
    opac = rng.uniform(0.0, 4.0, (N, 1))
    opac[:NBIG] = 6.0
    means = rng.uniform(-0.5, 0.5, (N, 3))
    means[:NBIG] *= 0.5
    p = {"means": means, "scales": np.log(scales),
         "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
         "opacities": opac, "features_dc": rng.uniform(-1.5, 1.5, (N, 3))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    extra = rng.normal(size=(N, n_color - 3)).astype(np.float32)
    eye = np.array([2.5, 0.3, 0.8])
    c2w = look_at_c2w(2.5 * eye / np.linalg.norm(eye), np.zeros(3))
    f = 1.4 * SIZE
    K = np.array([[f, 0, SIZE / 2], [0, f, SIZE / 2], [0, 0, 1]],
                 np.float32)
    return p, extra, K, c2w


def jax_render(p, extra, cam, stop, sink=None):
    colors = jnp.concatenate([jsh0(p["features_dc"]), extra], axis=1)
    return jrast.render_tiled_pallas(
        p["means"], p["quats"], jnp.exp(p["scales"]),
        jax.nn.sigmoid(p["opacities"][:, 0]), colors, cam, JOpts(**OPTS),
        absgrad_sink=sink, stop_threshold=stop, interpret=True)


def port_render(p, extra, cam, stop, sink=None):
    colors = torch.cat([tsh0(p["features_dc"]), extra], dim=1)
    return trast.render_tiled_pallas(
        p["means"], p["quats"], torch.exp(p["scales"]),
        torch.sigmoid(p["opacities"][:, 0]), colors, cam,
        TOpts(stop_threshold=stop, **OPTS), absgrad_sink=sink)


@pytest.mark.parametrize("n_color,stop", [(3, 0.0), (3, 1e-4), (16, 1e-4)])
def test_render_matches_jax(n_color, stop):
    p, extra, K, c2w = scene(n_color)
    jcam, tcam = both_cameras(K, c2w, SIZE, SIZE)
    ref = jax.jit(lambda pp, ex: jax_render(pp, ex, jcam, stop)[0])(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(extra))
    got, meta = port_render({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(extra), tcam, stop)
    for name in MAPS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.shape[:2] == (SIZE, SIZE), name
        tol = dict(rtol=1e-5, atol=1e-4) if name == "depth" else TOL
        np.testing.assert_allclose(a, b, err_msg=name, **tol)
    assert got.color.shape[-1] == n_color
    assert int(got.spilled) == int(ref.spilled) > 0
    lens = meta.bins.starts[1:] - meta.bins.starts[:-1]
    assert int(lens.max()) > OPTS["tile_capacity"]
    assert float(got.alpha.mean()) > 0.5


def jax_loss(target, cam, stop):
    def loss(p, sink):
        out, meta = jax_render(p, jnp.zeros((N, 0)), cam, stop, sink)
        value = (jnp.mean((out.color - target) ** 2)
                 + 0.05 * jnp.mean(out.depth * target[..., 0])
                 + 0.05 * jnp.mean(out.normal * target)
                 + 0.05 * jnp.mean(out.alpha)
                 + 0.02 * jnp.mean(out.median_depth * target[..., 1]))
        # The meta's array fields (jit returns arrays only).
        return value, (meta.proj, meta.aligned_gid)
    return loss


@pytest.fixture(scope="module")
def gradients():
    """(JAX and port) loss, gradients with respect to the raw parameters
    and the sink, and render meta, at stop_threshold 1e-4."""
    p, _, K, c2w = scene(3)
    jcam, tcam = both_cameras(K, c2w, SIZE, SIZE)
    target = np.random.default_rng(5).uniform(
        0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    shape = jrast.pallas_sink_shape(SIZE, SIZE, N, JOpts(**OPTS))
    assert trast.pallas_sink_shape(SIZE, SIZE, N, TOpts(**OPTS)) == shape
    f = jax.jit(jax.value_and_grad(jax_loss(jnp.asarray(target), jcam, 1e-4),
                                   argnums=(0, 1), has_aux=True))
    (jl, (proj, gid)), (jg, jsink) = f(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.zeros(shape, jnp.float32))
    jmeta = jrast.RenderMeta(proj=proj, bins=None, width=SIZE, height=SIZE,
                             aligned_gid=gid)

    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    sink = torch.zeros(shape, requires_grad=True)
    out, tmeta = port_render(tp, torch.zeros((N, 0)), tcam, 1e-4, sink)
    tt = torch.from_numpy(target)
    tl = (torch.mean((out.color - tt) ** 2)
          + 0.05 * torch.mean(out.depth * tt[..., 0])
          + 0.05 * torch.mean(out.normal * tt)
          + 0.05 * torch.mean(out.alpha)
          + 0.02 * torch.mean(out.median_depth * tt[..., 1]))
    grads = torch.autograd.grad(tl, [tp[k] for k in NAMES] + [sink])
    return ((float(jl), {k: np.asarray(jg[k]) for k in NAMES},
             np.asarray(jsink), jmeta),
            (float(tl.detach()),
             dict(zip(NAMES, (g.numpy() for g in grads[:-1]))), grads[-1],
             tmeta))


def assert_grad_close(a, b, name):
    scale = np.abs(b).max()
    assert scale > 0, name
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_gradient_matches(gradients, name):
    (jl, jg, _, _), (tl, tg, _, _) = gradients
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_grad_close(tg[name], jg[name], name)


def test_sink_gradient_matches(gradients):
    (_, _, jsink, jmeta), (_, _, tsink, tmeta) = gradients
    assert tsink.shape == jsink.shape == (2, tmeta.aligned_gid.shape[0])
    np.testing.assert_array_equal(tmeta.aligned_gid.numpy(),
                                  np.asarray(jmeta.aligned_gid))
    assert_grad_close(tsink.numpy(), jsink, "sink")
    # Padding slots carry no gradient.
    assert not tsink[:, ~tmeta.aligned_valid].any()


def test_update_state_from_isect_matches(gradients):
    (_, _, jsink, jmeta), (_, _, tsink, tmeta) = gradients
    rng = np.random.default_rng(13)
    init = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    jst = jstrategy.update_state_from_isect(
        jstrategy.StrategyState(*(jnp.asarray(x) for x in init)), jmeta,
        jnp.asarray(jsink))
    tst = tstrategy.update_state_from_isect(
        tstrategy.StrategyState(*(torch.from_numpy(x) for x in init)),
        tmeta, tsink)
    assert_grad_close(tst.grad_accum.numpy(), np.asarray(jst.grad_accum),
                      "grad_accum")
    assert np.array_equal(tst.count.numpy(), np.asarray(jst.count))
    np.testing.assert_allclose(tst.max_radii.numpy(),
                               np.asarray(jst.max_radii), rtol=1e-6)
    assert float((tst.grad_accum - torch.from_numpy(init[0])).max()) > 0


def test_render_reads_rows_through_the_ids(monkeypatch):
    """The render composites the per-gaussian rows through the aligned ids:
    it builds no packed per-intersection matrix."""
    def refuse(*args):
        raise AssertionError("render_tiled_pallas called pack_intersections")

    monkeypatch.setattr(trast, "pack_intersections", refuse)
    p, extra, K, c2w = scene(3)
    _, tcam = both_cameras(K, c2w, SIZE, SIZE)
    got, meta = port_render({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(extra), tcam, 1e-4)
    assert float(got.alpha.mean()) > 0.5
    assert meta.aligned_gid is not None


@pytest.mark.parametrize("n_color", [3, 16])
def test_pack_intersections_is_the_gather(n_color):
    """``pack_intersections``' matrix is the compositor's gather of the
    padded per-gaussian rows at every real slot."""
    rng = np.random.default_rng(n_color)
    n, m = 50, 700

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    proj = trast.Projection(mean2d=t(n, 2), depth=t(n), conic=t(n, 3),
                            radius=t(n), compensation=t(n), plane=t(n, 2),
                            normal=t(n, 3), valid=torch.ones(n, dtype=bool),
                            radius_xy=t(n, 2))
    opac, colors, normal = t(n), t(n, n_color), t(n, 3)
    gid = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    valid = torch.from_numpy(rng.uniform(size=m) < 0.8)
    packed = trast.pack_intersections(proj, opac, colors, normal, gid, valid)
    per_gauss = trast.pad_per_gauss(
        trast.pack_per_gauss(proj, opac, normal, colors))
    gathered = composite.gather_slots(per_gauss, gid)
    assert packed.shape == gathered.shape == (
        composite.row_width(n_color), m)
    assert torch.equal(packed[:, valid], gathered[:, valid])

"""One train step of the port against the JAX package's, on the CPU.

From identical numpy parameters (400 Gaussians, 64x64, sh_degree 3 at step
3000 so every SH band is live, antialiased, black background), the port's
loss and its gradients with respect to every parameter and to the
rasterizer's screen-space sink are held against ``jax.value_and_grad`` of
the JAX trainer's ``loss_fn`` (train/trainer.py:181-220), with the
depth-normal phase off and on (scale regularization on, at a step where
it applies), with the batched compositor (``backend="xla"``) and with the
per-tile one (``backend="pallas"``, JAX's Pallas kernels in interpret
mode, its per-intersection sink).  Then three Adam steps against optax,
and the densification statistics' update (``update_state``, or
``update_state_from_isect`` for "pallas") against JAX's.

Tolerances: the loss within rtol 1e-5; gradients within rtol 5e-4 and
atol 5e-5 * max|g| (tests/test_pallas.py:205-206); Adam, fed the same
gradients, within rtol 1e-5 and atol 1e-6, a few float32 ulps of
parameters of order 1 (optax divides by sqrt(nu / (1 - b2^t)) + eps, torch
by sqrt(nu) / sqrt(1 - b2^t) + eps: the same function rounded otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.options import RenderOptions as JOpts
from collab_splats_tpu.models import rade_gs as jrade
from collab_splats_tpu.ops import rasterize as jrast
from collab_splats_tpu.train import optim as joptim
from collab_splats_tpu.train import strategy as jstrategy
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.models import rade_gs as trade
from collab_splats_tpu_torch.models.gaussians import params_from_numpy
from collab_splats_tpu_torch.ops import rasterize as trast
from collab_splats_tpu_torch.train import optim as toptim
from collab_splats_tpu_torch.train import strategy as tstrategy
from test_torch_core import both_cameras, numpy_scene

torch.set_num_threads(2)
N, SIZE, STEP = 400, 64, 3000
OPTS = dict(rasterize_mode="antialiased", tile_capacity=128,
            max_intersections=1 << 14)


def configs(reg, backend):
    kw = dict(sh_degree=3, background="black", use_scale_regularization=reg,
              use_depth_normal_loss=True)
    pallas = backend == "pallas"
    return (jrade.RadeGSConfig(render=JOpts(backend=backend,
                                            pallas_interpret=pallas, **OPTS),
                               **kw),
            trade.RadeGSConfig(render=TOpts(backend=backend, **OPTS), **kw))


def sink_shape(module, backend, cfg):
    shape = module.pallas_sink_shape if backend == "pallas" \
        else module.absgrad_sink_shape
    return shape(SIZE, SIZE, N, cfg.render)


def update(module, backend):
    return module.update_state_from_isect if backend == "pallas" \
        else module.update_state


def assert_grad_close(a, b, name):
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5 * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def scene():
    p, K, c2w = numpy_scene(N, seed=11, sh_degree=3, width=SIZE,
                            height=SIZE)
    image = np.random.default_rng(12).uniform(
        0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    return p, K, c2w, image


def jax_step(scene, reg, backend):
    p, K, c2w, image = scene
    jcfg, _ = configs(reg, backend)
    jcam, _ = both_cameras(K, c2w, SIZE, SIZE)
    alive = jnp.ones(N, bool)

    @jax.jit
    def value_and_grad(params, sink):
        def loss_fn(params, sink):
            outputs, meta = jrade.get_outputs(
                params, alive, jcam, STEP, jcfg, rng=None, training=True,
                compute_error_maps=reg, absgrad_sink=sink)
            loss, ldict = jrade.get_loss(outputs, jnp.asarray(image), params,
                                         alive, STEP, jcfg, reg_active=reg)
            return loss, (ldict, meta)

        return jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
            params, sink)

    sink = jnp.zeros(sink_shape(jrast, backend, jcfg), jnp.float32)
    (loss, (ldict, meta)), (pg, sg) = value_and_grad(
        {k: jnp.asarray(v) for k, v in p.items()}, sink)
    return loss, ldict, meta, pg, sg


def port_step(scene, reg, backend):
    p, K, c2w, image = scene
    _, tcfg = configs(reg, backend)
    _, tcam = both_cameras(K, c2w, SIZE, SIZE)
    alive = torch.ones(N, dtype=torch.bool)
    params = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(p, device="cpu").items()}
    sink = torch.zeros(sink_shape(trast, backend, tcfg), requires_grad=True)
    outputs, meta = trade.get_outputs(
        params, alive, tcam, STEP, tcfg, training=True,
        compute_error_maps=reg, absgrad_sink=sink)
    loss, ldict = trade.get_loss(outputs, torch.from_numpy(image), params,
                                 alive, STEP, tcfg, reg_active=reg)
    grads = torch.autograd.grad(loss, list(params.values()) + [sink])
    return loss, ldict, meta, dict(zip(params, grads[:-1])), grads[-1]


@pytest.fixture(scope="module", params=[
    (False, "xla"), (True, "xla"), (False, "pallas"), (True, "pallas")],
    ids=["reg_off", "reg_on", "pallas-reg_off", "pallas-reg_on"])
def steps(request, scene):
    reg, backend = request.param
    return (reg, backend), jax_step(scene, reg, backend), \
        port_step(scene, reg, backend)


def test_loss_terms_match(steps):
    (reg, _), (jloss, jdict, *_), (tloss, tdict, *_) = steps
    assert set(tdict) == set(jdict)
    assert ("depth_normal_loss" in tdict) == reg
    assert ("scale_reg" in tdict) == reg
    for k in jdict:
        np.testing.assert_allclose(float(tdict[k].detach()),
                                   float(jdict[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)


def test_parameter_gradients_match(steps):
    _, (*_, jgrads, _), (*_, tgrads, _) = steps
    assert set(tgrads) == set(jgrads)
    for k, g in tgrads.items():
        ref = np.asarray(jgrads[k])
        assert np.abs(ref).max() > 0, k
        assert_grad_close(g.numpy(), ref, k)


def test_sink_gradient_matches(steps):
    _, (*_, jsink), (*_, tsink) = steps
    ref = np.asarray(jsink)
    assert tsink.shape == ref.shape and np.abs(ref).max() > 0
    assert_grad_close(tsink.numpy(), ref, "sink")


def test_update_state_matches(steps):
    (_, backend), (_, _, jmeta, _, jsink), (_, _, tmeta, _, tsink) = steps
    rng = np.random.default_rng(13)
    init = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    jst = update(jstrategy, backend)(
        jstrategy.StrategyState(*(jnp.asarray(x) for x in init)), jmeta,
        jsink)
    tst = update(tstrategy, backend)(
        tstrategy.StrategyState(*(torch.from_numpy(x) for x in init)),
        tmeta, tsink)
    assert_grad_close(tst.grad_accum.numpy(), np.asarray(jst.grad_accum),
                      "grad_accum")
    assert np.array_equal(tst.count.numpy(), np.asarray(jst.count))
    np.testing.assert_allclose(tst.max_radii.numpy(),
                               np.asarray(jst.max_radii), rtol=1e-6)
    assert float((tst.grad_accum - torch.from_numpy(init[0])).max()) > 0


def test_three_adam_steps_match_optax(scene, steps):
    _, (*_, jgrads, _), _ = steps
    p = scene[0]
    rng = np.random.default_rng(14)
    g1 = {k: np.asarray(v) for k, v in jgrads.items()}
    seq = [g1,
           {k: (-0.5 * v + 1e-3 * rng.normal(size=v.shape)).astype(
               np.float32) for k, v in g1.items()},
           {k: 2.0 * v for k, v in g1.items()}]
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    jopt = joptim.make_optimizer(joptim.RADE_GS_GROUPS,
                                 joptim.default_labels(jparams))
    jstate = jopt.init(jparams)
    tparams = {k: v.requires_grad_(True)
               for k, v in params_from_numpy(p, device="cpu").items()}
    topt, sched = toptim.make_optimizer(tparams, toptim.RADE_GS_GROUPS)
    for grads in seq:
        updates, jstate = jopt.update({k: jnp.asarray(v)
                                       for k, v in grads.items()},
                                      jstate, jparams)
        jparams = {k: jparams[k] + updates[k] for k in jparams}
        for k, v in grads.items():
            tparams[k].grad = torch.tensor(v)
        topt.step()
        sched.step()
        for k in jparams:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # The means' rate decays with the step count; the others stay put.
    lrs = {g["name"]: g["lr"] for g in topt.param_groups}
    sched_means = joptim.nerfstudio_exponential_decay(
        joptim.RADE_GS_GROUPS["means"])
    # (The JAX schedule runs in float32, the port's in double.)
    np.testing.assert_allclose(lrs["means"], float(sched_means(3)),
                               rtol=1e-5)
    assert lrs["opacities"] == pytest.approx(
        toptim.RADE_GS_GROUPS["opacities"].lr, rel=1e-12)

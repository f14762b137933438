"""Parity of the port's densification strategy with the JAX package, on the
CPU.

``refine`` of both packages runs on the same capacity table and statistics
with the same split noise (the JAX draws, handed to the port), and must
decide row for row alike: which rows are duplicated, split, culled, written
and alive, and the counts.  Parameter values agree within rtol 1e-6 (the
children's offsets are a float32 rotation of scaled noise, summed in
another order).  The optimizer-state helpers (``zero_opt_rows``,
``zero_group_moments``, ``grow_capacity`` + ``graft_opt_state``) are held
against their optax counterparts on the same gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.models import gaussians as jgauss
from collab_splats_tpu.train import optim as joptim
from collab_splats_tpu.train import strategy as jstrategy
from collab_splats_tpu_torch.models import gaussians as tgauss
from collab_splats_tpu_torch.train import optim as toptim
from collab_splats_tpu_torch.train import strategy as tstrategy

torch.set_num_threads(2)
CAP = 256
CFG = jstrategy.StrategyConfig()
TCFG = tstrategy.StrategyConfig(**dataclasses.asdict(CFG))


def table(n_alive, seed):
    """A capacity table whose statistics trigger every kind of decision:
    high-gradient small rows (dup), high-gradient large rows (split), faint
    rows (cull), huge rows (scale cull) and large screen radii."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(CAP, 4))
    p = {
        "means": rng.uniform(-1, 1, (CAP, 3)),
        "scales": np.log(rng.choice([0.003, 0.03, 0.8], (CAP, 3),
                                    p=[0.5, 0.45, 0.05])),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "opacities": rng.uniform(-4, 3, (CAP, 1)),
        "features_dc": rng.normal(size=(CAP, 3)),
        "features_rest": rng.normal(size=(CAP, 15, 3)),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    alive = np.arange(CAP) < n_alive
    state = [rng.uniform(0, 2e-3, CAP) * rng.integers(1, 5, CAP),
             rng.integers(0, 5, CAP).astype(np.float64),
             rng.uniform(0, 0.2, CAP)]
    return p, alive, [s.astype(np.float32) for s in state]


def refine_both(p, alive, state, **flags):
    key = jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, j), (CAP, 3)))
        for j in range(CFG.n_split_samples)])
    ref = jstrategy.refine(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(alive),
        jstrategy.StrategyState(*(jnp.asarray(s) for s in state)), key, CFG,
        **flags)
    got = tstrategy.refine(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(alive),
        tstrategy.StrategyState(*(torch.from_numpy(s) for s in state)),
        TCFG, noise=torch.from_numpy(noise), **flags)
    return got, ref


def assert_refine_match(got, ref):
    for name in ("alive", "written"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    for name in ("n_dup", "n_split", "n_cull", "dropped"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    for k, v in ref.params.items():
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for s in got.state:
        assert float(s.abs().max()) == 0.0


@pytest.mark.parametrize("flags", [
    dict(),
    dict(allow_split=False),
    dict(allow_dup=False),
    dict(scale_cull=True, screen_size_cull=True),
    dict(allow_split=False, allow_dup=False, scale_cull=True),
], ids=["dup_split_cull", "dup_cull", "split_cull", "all_culls",
        "cull_only"])
def test_refine_matches_row_for_row(flags):
    p, alive, state = table(150, seed=1)
    got, ref = refine_both(p, alive, state, **flags)
    assert_refine_match(got, ref)
    assert int(got.n_cull) > 0
    if flags.get("allow_split", True):
        assert int(got.n_split) > 0
    if flags.get("allow_dup", True):
        assert int(got.n_dup) > 0


def test_refine_on_a_full_table_drops_and_counts():
    p, alive, state = table(CAP - 4, seed=2)
    got, ref = refine_both(p, alive, state)
    assert_refine_match(got, ref)
    assert int(got.dropped) > 0


def test_reset_opacity_matches():
    p, _, _ = table(150, seed=3)
    ref = jstrategy.reset_opacity({k: jnp.asarray(v) for k, v in p.items()},
                                  CFG)
    got = tstrategy.reset_opacity({k: torch.from_numpy(v)
                                   for k, v in p.items()}, TCFG)
    assert np.array_equal(got["opacities"].numpy(),
                          np.asarray(ref["opacities"]))
    assert got["means"] is not None and float(got["opacities"].max()) < 0


def moments(jstate, topt, name):
    """((mu, nu) of optax's group ``name``, (exp_avg, exp_avg_sq) of the
    torch group ``name``)."""
    inner = jstate.inner_states[name].inner_state[0]
    st = topt.state[toptim.group_param(topt, name)]
    return ((np.asarray(inner.mu[name]), np.asarray(inner.nu[name])),
            (st["exp_avg"].numpy(), st["exp_avg_sq"].numpy()))


def assert_moments_match(jstate, topt):
    for name in toptim.RADE_GS_GROUPS:
        (mu, nu), (m, v) = moments(jstate, topt, name)
        np.testing.assert_allclose(m, mu, rtol=1e-6, atol=1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(v, nu, rtol=1e-6, atol=1e-18,
                                   err_msg=name)


def test_optimizer_state_helpers_match_optax():
    p, alive, _ = table(150, seed=4)
    rng = np.random.default_rng(5)
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    jopt = joptim.make_optimizer(joptim.RADE_GS_GROUPS,
                                 joptim.default_labels(jparams))
    jstate = jopt.init(jparams)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    topt, sched = toptim.make_optimizer(tparams, toptim.RADE_GS_GROUPS)

    def step():
        nonlocal jparams, jstate
        upd, jstate = jopt.update({k: jnp.asarray(v)
                                   for k, v in grads.items()}, jstate,
                                  jparams)
        jparams = {k: jparams[k] + upd[k] for k in jparams}
        for k, v in grads.items():
            tparams[k].grad = torch.tensor(v)
        topt.step()
        sched.step()

    step()
    assert_moments_match(jstate, topt)
    written = rng.uniform(size=CAP) < 0.3
    jstate = jstrategy.zero_opt_rows(jstate, jnp.asarray(written))
    tstrategy.zero_opt_rows(topt, torch.from_numpy(written))
    assert_moments_match(jstate, topt)
    assert moments(jstate, topt, "means")[1][0][written].max() == 0.0

    jstate = joptim.zero_group_moments(jstate, "opacities")
    toptim.zero_group_moments(topt, "opacities")
    assert_moments_match(jstate, topt)
    st = topt.state[toptim.group_param(topt, "opacities")]
    assert float(st["exp_avg_sq"].abs().max()) == 0.0
    assert float(st["step"]) == 1.0

    # Capacity growth: moments of surviving rows kept, new rows zero, the
    # step count kept; then both take one more step alike.  Parameters
    # agree within a few float32 ulps after each Adam step.
    jparams, jalive = jgauss.grow_capacity(jparams, jnp.asarray(alive),
                                           2 * CAP)
    jstate = joptim.graft_opt_state(jopt.init(jparams), jstate)
    grown, talive = tgauss.grow_capacity(
        {k: v.detach() for k, v in tparams.items()},
        torch.from_numpy(alive), 2 * CAP)
    tparams = {k: v.requires_grad_(True) for k, v in grown.items()}
    toptim.graft_opt_state(topt, tparams)
    assert np.array_equal(talive.numpy(), np.asarray(jalive))
    for k in p:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jparams[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert_moments_match(jstate, topt)
    grads = {k: np.concatenate([v, np.zeros_like(v)]) for k, v in
             grads.items()}
    step()
    assert_moments_match(jstate, topt)
    for k in p:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jparams[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_init_from_points_matches():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    jp, jalive = jgauss.init_from_points(jnp.asarray(pts), jnp.asarray(cols),
                                         jax.random.PRNGKey(0), capacity=256)
    tp, talive = tgauss.init_from_points(pts, cols, torch.Generator(),
                                         capacity=256, device="cpu")
    assert np.array_equal(talive.numpy(), np.asarray(jalive))
    assert int(tgauss.num_alive(talive)) == 200
    for k in jp:
        if k == "quats":   # random draws: only their norms compare
            np.testing.assert_allclose(
                np.linalg.norm(tp[k].numpy()[:200], axis=-1), 1.0, rtol=1e-6)
            continue
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)

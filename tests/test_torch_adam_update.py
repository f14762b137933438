"""Kernel 10, the train step's update (``ops/cuda/adam_update.py``, driven
by ``train/optim.py::adam_step``), and the guard's plain version.

On the CPU ``adam_step`` equals, bit for bit, what the trainer ran before
it: the dead rows' gradients zeroed by a mask multiply and fed to
``torch.optim.Adam``, with the ``LambdaLR`` schedule, over the rade-gs
table and the rade-features one (its empty ``[N, 0, 3]`` group and the
decoder's tensors), with a None gradient; its state survives a
``state_dict`` round trip, ``graft_opt_state`` and ``zero_group_moments``;
a non-finite gradient leaves parameters, moments, step counts and the
schedule as they were; ``Trainer._update`` follows optax over three steps;
the counters.  On a card: the kernel bit for bit against torch's foreach
Adam at the bench scene's 2,524,288 rows, unaligned lengths and views
against it too, repeats bit-identical, the guard, and the launches a step.
"""

import copy

import numpy as np
import pytest
import torch

from collab_splats_tpu_torch.core.options import RenderOptions
from collab_splats_tpu_torch.data import synthetic
from collab_splats_tpu_torch.models import rade_gs
from collab_splats_tpu_torch.ops.cuda import adam_update as op
from collab_splats_tpu_torch.ops.cuda import build
from collab_splats_tpu_torch.train import optim, strategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig
from collab_splats_tpu_torch.utils import profiling

torch.set_num_threads(2)
# Each table's per-row shapes, and the decoder's tensors (latent 13,
# hidden 64, CLIP 768 and DINOv2 384).
GS = {"means": (3,), "features_dc": (3,), "features_rest": (15, 3),
      "opacities": (1,), "scales": (3,), "quats": (4,)}
FEATURES = {**GS, "features_rest": (0, 3), "distill_features": (13,)}
DECODER = [(64, 13), (64,), (768, 64), (768,), (384, 64), (384,)]
TABLES = {"gs": (GS, optim.RADE_GS_GROUPS),
          "features": (FEATURES, optim.RADE_FEATURES_GROUPS)}
N = 301   # rows: groups of 301 * w elements leave float4 tails


def make_table(kind, n, seed, device="cpu"):
    """(params by group name, the groups, the Gaussian groups' names) of
    a seeded table at ``n`` rows; the decoder group holds a list."""
    rows, groups = TABLES[kind]
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(shape):
        return torch.randn(shape, generator=gen, device=device
                           ).requires_grad_(True)

    params = {k: leaf((n,) + w) for k, w in rows.items()}
    if kind == "features":
        params["decoder"] = [leaf(s) for s in DECODER]
    return params, groups, list(rows)


def make_grads(params, seed, none=()):
    """Seeded gradients by group name (lists), None for the groups in
    ``none``; scales vary by group so that moments differ in size."""
    out = {}
    for i, (k, v) in enumerate(params.items()):
        ts = v if isinstance(v, list) else [v]
        gen = torch.Generator(device=ts[0].device).manual_seed(seed + i)
        out[k] = [None if k in none else
                  10.0 ** (i % 3 - 1) * torch.randn(t.shape, generator=gen,
                                                    device=t.device)
                  for t in ts]
    return out


def make_alive(n, seed, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=gen, device=device) < 0.6


def optimizer(params, groups):
    return optim.make_optimizer(
        {k: [t.detach().clone().requires_grad_(True) for t in v]
         if isinstance(v, list) else v.detach().clone().requires_grad_(True)
         for k, v in params.items()}, groups)


def reference_step(opt, sched, grads, alive, masked):
    """The trainer's former update: masked gradients into
    ``torch.optim.Adam`` (and ``sched``, where there is one)."""
    amask = alive.to(torch.float32)
    for group in opt.param_groups:
        for p, g in zip(group["params"], grads[group["name"]]):
            g = torch.zeros_like(p) if g is None else g
            if group["name"] in masked:
                g = g * amask.reshape((-1,) + (1,) * (g.dim() - 1))
            p.grad = g
    opt.step()
    if sched is not None:
        sched.step()
    opt.zero_grad(set_to_none=True)


def fused_step(opt, sched, grads, alive, masked):
    n = optim.adam_step(opt, grads, alive, masked)
    sched.step()
    return n


def same(a, b, path="") -> None:
    """Assert two nested states (dicts, lists, tensors, numbers) equal, bit
    for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def same_optimizers(a, b) -> None:
    (oa, sa), (ob, sb) = a, b
    same(oa.state_dict(), ob.state_dict(), "optimizer")
    same(sa.state_dict(), sb.state_dict(), "scheduler")
    for ga, gb in zip(oa.param_groups, ob.param_groups):
        for pa, pb in zip(ga["params"], gb["params"]):
            same(pa.detach(), pb.detach(), ga["name"])


@pytest.mark.parametrize("kind", list(TABLES))
def test_plain_update_equals_torch_adam(kind):
    params, groups, masked = make_table(kind, N, seed=1)
    alive = make_alive(N, seed=2)
    ref, got = optimizer(params, groups), optimizer(params, groups)
    for step in range(3):
        # A None gradient in the second step: the group takes zeros.
        grads = make_grads(params, 10 * step,
                           none=("quats",) if step == 1 else ())
        reference_step(*ref, grads, alive, masked)
        fused_step(*got, grads, alive, masked)
        same_optimizers(ref, got)
    # Dead rows never moved.
    for group in got[0].param_groups:
        if group["name"] in masked:
            p = group["params"][0]
            same(p.detach()[~alive], params[group["name"]].detach()[~alive])


def test_a_none_gradient_is_a_zero_one():
    params, groups, masked = make_table("gs", N, seed=3)
    alive = make_alive(N, seed=4)
    a, b = optimizer(params, groups), optimizer(params, groups)
    for step in range(2):
        grads = make_grads(params, step, none=("scales",) if step else ())
        fused_step(*a, grads, alive, masked)
        if step:
            grads["scales"] = [torch.zeros((N, 3))]
        fused_step(*b, grads, alive, masked)
    same_optimizers(a, b)
    # The second step moved the scales by their momentum alone.
    st = a[0].state[optim.group_param(a[0], "scales")]
    assert st["exp_avg"][alive].abs().min() > 0


def test_state_dict_round_trip():
    params, groups, masked = make_table("features", N, seed=5)
    alive = make_alive(N, seed=6)
    a = optimizer(params, groups)
    for step in range(2):
        fused_step(*a, make_grads(params, step), alive, masked)
    b = optimizer(params, groups)
    for ga, gb in zip(a[0].param_groups, b[0].param_groups):
        with torch.no_grad():
            for pa, pb in zip(ga["params"], gb["params"]):
                pb.copy_(pa)
    b[0].load_state_dict(copy.deepcopy(a[0].state_dict()))
    b[1].load_state_dict(copy.deepcopy(a[1].state_dict()))
    grads = make_grads(params, 7)
    fused_step(*a, grads, alive, masked)
    fused_step(*b, grads, alive, masked)
    same_optimizers(a, b)


def test_graft_and_zero_moments_after_fused_steps():
    """The opacity reset's ``zero_group_moments`` and capacity growth's
    ``graft_opt_state`` act on the state the fused steps left as on
    ``torch.optim.Adam``'s, and the steps after them agree."""
    params, groups, masked = make_table("gs", N, seed=8)
    alive = make_alive(N, seed=9)
    ref, got = optimizer(params, groups), optimizer(params, groups)
    for step in range(2):
        grads = make_grads(params, 20 + step)
        reference_step(*ref, grads, alive, masked)
        fused_step(*got, grads, alive, masked)
    for opt, _ in (ref, got):
        optim.zero_group_moments(opt, "opacities")
    grown = 2 * N
    new_alive = torch.cat([alive, torch.ones(N, dtype=torch.bool)])
    for opt, _ in (ref, got):
        new = {}
        for group in opt.param_groups:
            old = group["params"][0]
            x = torch.zeros((grown,) + old.shape[1:])
            x[:N] = old.detach()
            new[group["name"]] = x.requires_grad_(True)
        optim.graft_opt_state(opt, new)
    big = {k: torch.zeros((grown,) + w) for k, w in GS.items()}
    grads = make_grads(big, 30)
    reference_step(*ref, grads, new_alive, masked)
    fused_step(*got, grads, new_alive, masked)
    same_optimizers(ref, got)


def test_counters_off_the_card():
    params, groups, masked = make_table("features", N, seed=11)
    alive = make_alive(N, seed=12)
    opt = optimizer(params, groups)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        n = fused_step(*opt, make_grads(params, 0), alive, masked)
    c = profiling.totals()["counters"]
    profiling.reset()
    want = N * (3 + 3 + 0 + 1 + 3 + 4 + 13) + sum(
        int(np.prod(s)) for s in DECODER)
    assert n == want
    assert c["train.adam_elems"] == want
    assert c["train.adam_fused_elems"] == 0


def test_the_update_takes_cuda_tensors_only():
    """Off the card ``adam_step`` runs ``torch.optim.Adam`` itself; the
    kernel's wrapper has no CPU fallback."""
    params, groups, masked = make_table("gs", N, seed=15)
    opt, _ = optimizer(params, groups)
    grads = make_grads(params, 0)
    entries = [op.AdamEntry(p.detach(), grads[gr["name"]][0],
                            torch.zeros_like(p), torch.zeros_like(p),
                            gr["name"] in masked, -1e-3, 0.5, 1e-15)
               for gr in opt.param_groups for p in gr["params"]]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        op.adam_update(entries, make_alive(N, seed=16), (0.9, 0.999))


@pytest.mark.parametrize("bad", ["nan", "inf", "-inf"])
@pytest.mark.parametrize("where", ["alive", "dead", "sink"])
def test_plain_guard(bad, where):
    params, _, _ = make_table("gs", N, seed=13)
    alive = make_alive(N, seed=14)
    grads = [g[0] for g in make_grads(params, 0, none=("quats",)).values()]
    sink = torch.randn((16, 8, 2))
    assert bool(op.all_finite(grads + [sink]))
    if where == "sink":
        sink[3, 5, 1] = float(bad)
    else:
        row = int(torch.nonzero(alive if where == "alive" else ~alive)[7])
        grads[2][row, 4, 1] = float(bad)
    assert not bool(op.all_finite(grads + [sink]))


def tiny_trainer(dev, cap=512, alive_rows=300, size=32):
    """A rade-gs trainer at SH 3 over a seeded scene of ``alive_rows``
    Gaussians in ``cap`` rows, two orbit cameras and seeded images."""
    gen = torch.Generator().manual_seed(3)
    params = synthetic.random_gaussian_params(
        gen, cap, sh_degree=3, extent=0.6, scale_range=(0.02, 0.06),
        device=dev)
    alive = torch.arange(cap, device=dev) < alive_rows
    cams = synthetic.orbit_cameras(2, radius=2.5, width=size, height=size,
                                   focal=1.1 * size, device=dev)
    images = [torch.rand((size, size, 3), generator=gen).to(dev)
              for _ in cams]
    cfg = rade_gs.RadeGSConfig(
        sh_degree=3, sh_degree_interval=1, background="black",
        render=RenderOptions(tile_capacity=256, max_intersections=1 << 15),
        use_depth_normal_loss=False)
    conf = TrainerConfig(model=cfg, max_iterations=100, strategy=(
        strategy.StrategyConfig(warmup_length=10 ** 7)))
    return Trainer(conf, cams, images, params, alive, device=dev)


def step_grads(tr, seed, bad=None):
    """Seeded gradients of the trainer's parameters and a sink, in the
    order ``_update`` takes them; ``bad`` puts a NaN into a dead row of
    the means' gradient."""
    gen = torch.Generator().manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen).to(p.device)
             for p in tr.params.values()]
    sink = torch.randn((4, 8, 2), generator=gen).to(tr.device)
    if bad is not None:
        grads[0][int(torch.nonzero(~tr.alive)[0]), 1] = bad
    return tuple(grads) + (sink,)


def test_a_nonfinite_step_changes_nothing():
    tr = tiny_trainer("cpu")
    tr.train_one_step()
    names = list(tr.params)
    before = tr.state()
    finite = tr._update(step_grads(tr, 1, bad=float("nan")), names, [], [],
                        None, False)
    assert not bool(finite)
    same(tr.state(), before)


def test_update_three_steps_match_optax(monkeypatch):
    """``Trainer._update`` over three steps of seeded gradients against
    optax fed the same gradients with the dead rows zeroed (tolerances of
    ``test_torch_train_step.py``'s Adam steps)."""
    import jax.numpy as jnp

    from collab_splats_tpu.train import optim as joptim

    tr = tiny_trainer("cpu")
    monkeypatch.setattr(strategy, "update_state", lambda st, meta, g: st)
    names = list(tr.params)
    amask = tr.alive.numpy()
    # Copies: JAX may alias a numpy buffer, which the update writes.
    jparams = {k: jnp.asarray(v.detach().numpy().copy())
               for k, v in tr.params.items()}
    jopt = joptim.make_optimizer(joptim.RADE_GS_GROUPS,
                                 joptim.default_labels(jparams))
    jstate = jopt.init(jparams)
    for step in range(3):
        grads = step_grads(tr, 40 + step)
        assert bool(tr._update(grads, names, [], [], None, False))
        jg = {k: jnp.asarray(g.numpy() * amask.reshape(
            (-1,) + (1,) * (g.dim() - 1))) for k, g in zip(names, grads)}
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = {k: jparams[k] + updates[k] for k in jparams}
        for k in names:
            np.testing.assert_allclose(tr.params[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# --------------------------------------------------------------- the card
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def entries_of(opt, grads, alive, masked):
    """The entries ``adam_step`` would build at the optimizer's next step,
    without advancing it (fresh state where there is none)."""
    out = []
    for group in opt.param_groups:
        b1, b2 = group["betas"]
        for p, g in zip(group["params"], grads[group["name"]]):
            st = opt.state[p]
            t = (st["step"].item() if st else 0.0) + 1
            m = st["exp_avg"] if st else torch.zeros_like(p)
            v = st["exp_avg_sq"] if st else torch.zeros_like(p)
            out.append(op.AdamEntry(
                p.detach(), g, m, v, group["name"] in masked,
                -(group["lr"] / (1 - b1 ** t)), (1 - b2 ** t) ** 0.5,
                group["eps"]))
    return out


def cloned(entries):
    return [op.AdamEntry(e.param.clone(), e.grad, e.exp_avg.clone(),
                         e.exp_avg_sq.clone(), e.masked, e.step_size,
                         e.bc2_sqrt, e.eps) for e in entries]


def same_bits(entries, opt, what):
    """Assert ``entries``' parameters and moments equal, bit for bit, those
    of ``opt``'s tensors in its order."""
    ps = [p for group in opt.param_groups for p in group["params"]]
    assert len(ps) == len(entries)
    for e, p in zip(entries, ps):
        st = opt.state[p]
        for name, a, b in (("param", e.param, p.detach()),
                           ("exp_avg", e.exp_avg, st["exp_avg"]),
                           ("exp_avg_sq", e.exp_avg_sq, st["exp_avg_sq"])):
            assert torch.equal(a, b), f"{what}: {name} {list(p.shape)}"


@pytest.mark.card
@pytest.mark.parametrize("kind", list(TABLES))
def test_kernel_matches_torch_adam_on_the_card(kind):
    """``adam_step`` against ``torch.optim.Adam``'s foreach step on the
    masked gradients, bit for bit, over three steps; the kernel alone on
    copies of the state, twice, bit-identical to each other and to it."""
    dev = cuda()
    n = 2_524_288
    params, groups, masked = make_table(kind, n, seed=50, device=dev)
    alive = make_alive(n, seed=51, device=dev)
    ref, got = optimizer(params, groups), optimizer(params, groups)
    build.launches.clear()
    for step in range(3):
        grads = make_grads(params, 60 + step,
                           none=("scales",) if step == 1 else ())
        reference_step(*ref, grads, alive, masked)
        start = entries_of(got[0], grads, alive, masked)
        once, again = cloned(start), cloned(start)
        op.adam_update(once, alive, (0.9, 0.999))
        op.adam_update(again, alive, (0.9, 0.999))
        same_bits(once, ref[0], f"{kind} step {step}, the kernel")
        same_bits(again, ref[0], f"{kind} step {step}, a repeat")
        assert fused_step(*got, grads, alive, masked) == sum(
            p.numel() for gr in got[0].param_groups for p in gr["params"])
        same_optimizers(ref, got)
        # Dead rows keep their parameters' bits.
        for group in got[0].param_groups:
            if group["name"] in masked:
                p = group["params"][0].detach()
                assert torch.equal(p[~alive], params[group["name"]][~alive])
    assert build.launches["adam_update"] == 9


def unaligned(x):
    """A copy of ``x`` whose first element lies 4 bytes past a 16-byte
    boundary."""
    return torch.empty(x.numel() + 1, device=x.device)[1:].view(
        x.shape).copy_(x)


@pytest.mark.card
def test_kernel_on_unaligned_tensors_on_the_card():
    """Lengths that leave float4 tails, and a parameter, a gradient or
    moments whose first element is not 16-byte aligned (the group runs as
    single floats), against torch's foreach Adam, bit for bit."""
    dev = cuda()
    n = 100_003
    gen = torch.Generator(device=dev).manual_seed(70)
    alive = make_alive(n, seed=71, device=dev)
    shapes = {f"w{w}": (n, w) for w in (1, 3, 13, 45)}
    shapes["flat"] = (1001,)
    masked = [k for k in shapes if k != "flat"]

    def opt_of(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.optim.Adam(
            [{"params": [torch.randn(s, generator=g, device=dev
                                     ).requires_grad_(True)],
              "lr": 1e-3 * (i + 1), "eps": 1e-8 if k == "flat" else 1e-15,
              "name": k} for i, (k, s) in enumerate(shapes.items())],
            betas=(0.9, 0.999))

    def grads():
        return {k: [torch.randn(s, generator=gen, device=dev)]
                for k, s in shapes.items()}

    ref, base = opt_of(72), opt_of(72)
    # A first step on both, so that the moments are not zero.
    first = grads()
    for opt in (ref, base):
        reference_step(opt, None, first, alive, masked)
    second = grads()
    start = entries_of(base, second, alive, masked)
    got = []
    for i, e in enumerate(cloned(start)):
        moments = (unaligned(e.exp_avg), unaligned(e.exp_avg_sq)) if i == 3 \
            else (e.exp_avg, e.exp_avg_sq)
        got.append(op.AdamEntry(
            unaligned(e.param) if i == 1 else e.param,
            unaligned(e.grad) if i == 2 else e.grad, *moments, e.masked,
            e.step_size, e.bc2_sqrt, e.eps))
    op.adam_update(got, alive, (0.9, 0.999))
    reference_step(ref, None, second, alive, masked)
    same_bits(got, ref, "unaligned")


@pytest.mark.card
def test_guard_on_the_card():
    dev = cuda()
    gen = torch.Generator(device=dev).manual_seed(80)
    xs = [torch.randn((n,), generator=gen, device=dev)
          for n in (4096, 4099, 1, 3 * 100_003)]
    xs.append(torch.randn((9000,), generator=gen, device=dev)[1:])
    for k in range(len(xs)):
        for pos in (0, -1, xs[k].numel() // 2):
            for bad in (float("nan"), float("inf"), float("-inf")):
                ys = [x.clone() for x in xs]
                if k == len(xs) - 1:
                    ys[k] = torch.empty(9000, device=dev)[1:].copy_(xs[k])
                ys[k][pos] = bad
                assert not bool(op.all_finite(ys)), (k, pos, bad)
    assert bool(op.all_finite(xs + [None]))
    many = [torch.ones(5, device=dev) for _ in range(op.MAX_CHECKS)]
    assert bool(op.all_finite(many))
    many[-1][2] = float("nan")
    assert not bool(op.all_finite(many))
    with pytest.raises(ValueError, match="more than the 64"):
        op.all_finite(many + [many[0]])


@pytest.mark.card
def test_launches_a_step_on_the_card():
    dev = cuda()
    tr = tiny_trainer(dev)
    names = list(tr.params)
    build.launches.clear()
    m = tr.train_one_step()
    torch.cuda.synchronize()
    assert m["nonfinite_grad"] == 0
    assert (build.launches["adam_finite"],
            build.launches["adam_update"]) == (1, 1)
    before = tr.state()
    build.launches.clear()
    assert not bool(tr._update(step_grads(tr, 2, bad=float("inf")), names,
                               [], [], None, False))
    assert (build.launches["adam_finite"],
            build.launches["adam_update"]) == (1, 0)
    same(tr.state(), before)

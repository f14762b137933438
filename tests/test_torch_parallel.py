"""The port's multi-device training (``parallel/``) against the JAX
package's, on the CPU.

The port's ranks are processes on gloo.  This file starts four of them
once, running itself as the worker (``python tests/test_torch_parallel.py
--rank R ...``): they build (2, 2), (2, 1), (1, 4) and (1, 2) meshes and
run every scenario, and rank 0 writes the results.  Meanwhile the JAX
references run in the pytest process on the conftest's virtual devices,
at the same mesh shapes and from the same numpy inputs: the all-gather
and tile-sharded steps at (2, 2) and the routed render at (1, 4).

``test_nccl_on_four_cards`` (marked ``card``) runs the same ranks on four
CUDA cards under NCCL and holds them to the same port-side checks; it
skips without four cards.  On a machine with four cards and no JAX:
``python -m pytest --noconftest -m card tests/test_torch_parallel.py``.

Tolerances are the JAX package's own between layouts
(tests/test_parallel.py): losses rel 1e-5 (1e-4 against the routed
step), means after two Adam steps rtol 1e-4 / atol 1e-6, ``grad_accum``
rtol 1e-3 / atol 1e-7, counts and alive masks equal; gradients within the
north star's rtol 5e-4 / atol 5e-5 * max|g|; the routed render within
tests/test_tile_sharded.py's bounds.

The JAX all-gather step differentiates its replicated whole-image loss on
every ``gauss`` member unscaled, so its raw gradients are G times the
single-device ones (Adam's scale invariance hides it);
``test_gradients_are_the_single_device_ones`` pins that beside the port's
unsharded gradient.  The scene (200 Gaussians at capacity 256, 32x32,
tile capacity 128) spills nothing, so JAX's sharded binning, which leaves
the ellipse cull without conics, and the port's, which culls as the
single-device render does, composite the same windows.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CAP, N, SIZE = 256, 200, 32
RANKS = 4
STEPS = 2
REFINE_STEPS, REFINE_AT = 4, 2
SEND_CAP = 32
TILE_N, TILE_SIZE = 512, 64      # the routed-render scenes
WORKER_TIMEOUT = 180


# ------------------------------------------------------------ shared inputs
def _numpy_params(seed, n, extent, scale_range=(0.01, 0.05)):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    p = {
        "means": rng.uniform(-extent, extent, (n, 3)),
        "scales": np.log(rng.uniform(*scale_range, (n, 3))),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "opacities": rng.uniform(0.5, 3.0, (n, 1)),
        "features_dc": rng.uniform(-1.5, 1.5, (n, 3)),
        "features_rest": np.zeros((n, 0, 3)),
    }
    return {k: v.astype(np.float32) for k, v in p.items()}


def _pad(p, cap):
    n = p["means"].shape[0]
    out = {}
    for k, v in p.items():
        pad = np.zeros((cap - n,) + v.shape[1:], np.float32)
        if k == "quats":
            pad[:, 0] = 1.0
        out[k] = np.concatenate([v, pad])
    return out


def _port_config(tile_capacity=128, max_intersections=1 << 13):
    from collab_splats_tpu_torch.core.options import RenderOptions
    from collab_splats_tpu_torch.models import rade_gs

    return rade_gs.RadeGSConfig(
        sh_degree=0, background="black",
        render=RenderOptions(tile_capacity=tile_capacity,
                             max_intersections=max_intersections),
        use_depth_normal_loss=True, regularization_from_iter=0)


def make_inputs(graft=True):
    """The numpy scene every scenario and every reference reads: a
    perturbed start at capacity 256, two orbit cameras at 32x32 and the
    ground truth's renders; the routed-render scene; and with ``graft``
    the JAX entry point's scene (``__graft_entry__._run_sharded_step``,
    drawn by JAX)."""
    from collab_splats_tpu_torch.data.synthetic import orbit_cameras
    from collab_splats_tpu_torch.models import rade_gs
    from collab_splats_tpu_torch.models.gaussians import params_from_numpy

    start = _pad(_numpy_params(0, N, 0.6), CAP)
    gt = _numpy_params(1, N, 0.6)
    cams = orbit_cameras(2, radius=2.5, width=SIZE, height=SIZE,
                         focal=1.1 * SIZE, device="cpu")
    cfg = _port_config()
    gtp = params_from_numpy(gt, device="cpu")
    with torch.no_grad():
        images = np.stack([rade_gs.get_outputs(
            gtp, torch.ones(N, dtype=torch.bool), c, 0, cfg,
            training=False)[0]["rgb"].numpy() for c in cams])
    tcam = orbit_cameras(3, radius=2.5, width=TILE_SIZE, height=TILE_SIZE,
                         focal=1.1 * TILE_SIZE, device="cpu")[0]
    inputs = {f"p_{k}": v for k, v in start.items()}
    inputs.update({f"t_{k}": v for k, v in _numpy_params(
        2, TILE_N, 0.8).items()})
    inputs.update(
        alive=np.arange(CAP) < N, images=images.astype(np.float32),
        K=np.stack([c.K.numpy() for c in cams]),
        c2w=np.stack([c.c2w.numpy() for c in cams]),
        tK=tcam.K.numpy(), tc2w=tcam.c2w.numpy())
    if graft:
        inputs.update({f"e_{k}": v for k, v in _graft_scene().items()})
    return inputs


def _graft_scene():
    """``_run_sharded_step``'s parameters on a (1, 2) mesh, as numpy."""
    import jax
    import jax.numpy as jnp

    from collab_splats_tpu.data.synthetic import random_gaussian_params
    from collab_splats_tpu.models.gaussians import pad_to_capacity

    capacity = 64 * 2
    p = random_gaussian_params(jax.random.PRNGKey(0), capacity // 2,
                               extent=0.5)
    p = pad_to_capacity(p, capacity)
    return {k: np.asarray(v) for k, v in jax.tree_util.tree_map(
        jnp.asarray, p).items()}


# ------------------------------------------------------------------ worker
def _worker(rank, init, inputs_path, out_path, device):
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(2)
    import torch.distributed as dist

    from collab_splats_tpu_torch.core.cameras import camera_from_numpy
    from collab_splats_tpu_torch.core.options import RenderOptions
    from collab_splats_tpu_torch.core.projection import project_gaussians
    from collab_splats_tpu_torch.core.sh import sh0_to_rgb
    from collab_splats_tpu_torch.data.synthetic import orbit_cameras
    from collab_splats_tpu_torch.parallel import mesh as pmesh
    from collab_splats_tpu_torch.parallel import tiles as ptiles
    from collab_splats_tpu_torch.parallel import train as ptrain
    from collab_splats_tpu_torch.train import optim, strategy

    pmesh.initialize_distributed(init, RANKS, rank, device_type=device)
    meshes = {
        "22": pmesh.make_mesh(2, 2, device),
        "21": pmesh.make_mesh(2, 1, device, ranks=[0, 1]),
        "14": pmesh.make_mesh(1, 4, device),
        "12": pmesh.make_mesh(1, 2, device, ranks=[0, 1]),
    }
    dev = meshes["22"].device
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in np.load(inputs_path).items()}
    full = {k[2:]: v for k, v in data.items() if k.startswith("p_")}
    alive_full = data["alive"]
    cams = ptrain.CameraBatch(K=data["K"], c2w=data["c2w"])
    images = data["images"]
    cfg = _port_config()
    out = {}

    def setup(mesh, params=full, alive=alive_full):
        leaves = {k: pmesh.shard(v, mesh).clone().requires_grad_(True)
                  for k, v in params.items()}
        opt = optim.make_optimizer(leaves, optim.RADE_GS_GROUPS)
        return leaves, pmesh.shard(alive, mesh).clone(), opt

    def host(x):
        return x.detach().cpu().numpy()

    def gather_state(mesh, leaves, alive, strat):
        res = {k: host(pmesh.unshard(v.detach(), mesh))
               for k, v in leaves.items()}
        res["alive"] = host(pmesh.unshard(alive, mesh))
        for name, x in zip(strat._fields, strat):
            res[name] = host(pmesh.unshard(x, mesh))
        return res

    def run(mesh, tile=False, send_cap=None, steps=STEPS, refine_at=()):
        leaves, alive, opt = setup(mesh)
        strat = strategy.init_state(alive.shape[0], device=dev)
        step = ptrain.make_sharded_train_step(
            mesh, opt, cfg, SIZE, SIZE, CAP, reg_active=True,
            tile_sharded=tile, send_cap=send_cap)
        refine = ptrain.make_sharded_refine_step(
            mesh, strategy.StrategyConfig(warmup_length=0, refine_every=1,
                                          densify_grad_thresh=1e-6,
                                          cull_alpha_thresh=0.05))
        metrics, counts = [], None
        for i in range(steps):
            _, strat, m = step(leaves, alive, strat, cams, images, i, seed=5)
            metrics.append([float(m["loss"]), float(m["psnr"]),
                            float(m["spilled"])])
            if i in refine_at:
                _, alive, strat, counts = refine(leaves, alive, opt, strat,
                                                 1000 + i)
        res = gather_state(mesh, leaves, alive, strat)
        res["metrics"] = np.asarray(metrics)
        if counts is not None:
            res["counts"] = np.asarray([int(c) for c in counts])
        # Every data row holds the same parameters and moments.
        mine = torch.cat([v.detach().reshape(-1) for v in leaves.values()]
                         + [s.reshape(-1) for st in opt[0].state.values()
                            for k, s in sorted(st.items()) if k != "step"])
        rows = pmesh.unshard(mine[None], mesh, pmesh.DATA_AXIS)
        res["rows_equal"] = np.asarray(all(torch.equal(rows[0], r)
                                           for r in rows))
        res["moments"] = host(mine)
        return res

    def keep(prefix, res):
        if rank == 0:
            out.update({f"{prefix}_{k}": v for k, v in res.items()})

    keep("ag", run(meshes["22"]))
    keep("ag_again", run(meshes["22"]))
    keep("tile", run(meshes["22"], tile=True))
    keep("cap", run(meshes["22"], tile=True, send_cap=SEND_CAP, steps=1))
    keep("ref22", run(meshes["22"], steps=REFINE_STEPS,
                      refine_at=(REFINE_AT,)))
    if rank < 2:
        keep("one", run(meshes["21"]))
        keep("ref21", run(meshes["21"], steps=REFINE_STEPS,
                          refine_at=(REFINE_AT,)))

    # Pre-Adam gradients of the (2, 2) step.
    mesh = meshes["22"]
    leaves, alive, opt = setup(mesh)
    step = ptrain.make_sharded_train_step(mesh, opt, cfg, SIZE, SIZE, CAP,
                                          reg_active=True)
    m, grads = step.gradients(leaves, alive, cams, images, 0, seed=5)
    keep("grad", {k: host(pmesh.unshard(g, mesh))
                  for k, g in grads.items()})
    try:
        step.gradients(leaves, alive, ptrain.CameraBatch(
            cams.K[:1], cams.c2w[:1]), images[:1], 0)
        keep("raises", {"camera_count": np.asarray(False)})
    except ValueError:
        keep("raises", {"camera_count": np.asarray(True)})

    # The routed render over four bands against the single-device render.
    mesh = meshes["14"]
    t = {k[2:]: v for k, v in data.items() if k.startswith("t_")}
    tcam = camera_from_numpy(host(data["tK"]), host(data["tc2w"]),
                             TILE_SIZE, TILE_SIZE, device=dev)
    topts = RenderOptions(tile_capacity=128, max_intersections=1 << 13,
                          exact_binning=True)

    def routed(n, send_cap, means=None, colors=None):
        sl = pmesh.shard
        m_ = sl(t["means"][:n] if means is None else means, mesh)
        q = sl(t["quats"][:n], mesh)
        s = sl(torch.exp(t["scales"][:n]), mesh)
        o = sl(torch.sigmoid(t["opacities"][:n, 0]), mesh)
        c = sl(sh0_to_rgb(t["features_dc"][:n]) if colors is None
               else colors, mesh)
        proj = project_gaussians(
            m_, q, s, tcam.viewmat(), tcam.K, TILE_SIZE, TILE_SIZE,
            eps2d=topts.eps2d, near_plane=topts.near_plane,
            far_plane=topts.far_plane, radius_clip=topts.radius_clip,
            opacities=o)
        return ptiles.render_tile_sharded(proj, o, c, tcam, topts, mesh,
                                          send_cap)

    with torch.no_grad():
        o, _, _ = routed(TILE_N, 512 // 4 * 4)
        keep("render", {"color": host(o.color), "depth": host(o.depth),
                        "alpha": host(o.alpha),
                        "spilled": np.asarray(int(o.spilled))})
        o, _, _ = routed(TILE_N, 8)
        keep("render8", {"color": host(o.color),
                         "spilled": np.asarray(int(o.spilled))})
    means = t["means"][:256].clone().requires_grad_(True)
    colors = sh0_to_rgb(t["features_dc"][:256]).requires_grad_(True)
    o, _, _ = routed(256, 256, means, colors)
    # The whole image is on every member: each differentiates 1/G of it.
    loss = (torch.sum(o.color) + torch.sum(o.depth)) / mesh.n_gauss
    gm, gc = torch.autograd.grad(loss, [means, colors])
    gm = pmesh.unshard(pmesh.shard(gm, mesh), mesh)
    gc = pmesh.unshard(pmesh.shard(gc, mesh), mesh)
    keep("rgrad", {"means": host(gm), "colors": host(gc)})
    # The slab is G * send_cap rows, whatever the table's size.
    proj = project_gaussians(
        pmesh.shard(t["means"], mesh), pmesh.shard(t["quats"], mesh),
        torch.exp(torch.full((TILE_N // 4, 3), -4.0, device=dev)),
        tcam.viewmat(), tcam.K, TILE_SIZE, TILE_SIZE)
    pb, eb, vb, _, _ = ptiles.route_to_bands(
        proj, torch.zeros((TILE_N // 4, 1), device=dev), TILE_SIZE,
        topts.tile_size, mesh, 64)
    keep("slab", {"rows": np.asarray([pb.depth.shape[0], eb.shape[0],
                                      vb.shape[0]])})

    # __graft_entry__._run_sharded_step's scene on a (1, 2) mesh.
    if rank < 2 and "e_means" in data:
        mesh = meshes["12"]
        e = {k[2:]: v for k, v in data.items() if k.startswith("e_")}
        ecap = e["means"].shape[0]
        ecams = orbit_cameras(1, radius=2.5, width=32, height=32,
                              focal=1.1 * 32, device=dev)
        ecfg = _port_config(64, 1 << 11)
        leaves, alive, opt = setup(mesh, e,
                                   torch.arange(ecap, device=dev) < ecap // 2)
        before = leaves["means"].detach().clone()
        step = ptrain.make_sharded_train_step(mesh, opt, ecfg, 32, 32, ecap,
                                              reg_active=True)
        _, _, m = step(leaves, alive, strategy.init_state(
            ecap // mesh.n_gauss, device=dev), ptrain.CameraBatch(
            ecams[0].K[None], ecams[0].c2w[None]),
            torch.zeros((1, 32, 32, 3), device=dev), 0, seed=1)
        delta = pmesh.unshard(leaves["means"].detach() - before, mesh)
        keep("graft", {"loss": np.asarray(float(m["loss"])),
                       "delta": np.asarray(float(delta.abs().max()))})
    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- references
def _jax_run(inputs, n_data, n_gauss, steps, capture=False, tile=False):
    """JAX ``make_sharded_train_step`` on the same inputs (with ``tile``
    its tile-sharded variant at ``send_cap`` = shard): (params, strat,
    metrics), or with ``capture`` the raw gradients of step 0 (an
    optimizer that keeps its gradients as its state)."""
    import jax
    import jax.numpy as jnp
    import optax

    from collab_splats_tpu.core.options import RenderOptions
    from collab_splats_tpu.models import rade_gs
    from collab_splats_tpu.parallel import mesh as pmesh
    from collab_splats_tpu.parallel.train import (CameraBatch,
                                                  make_sharded_train_step)
    from collab_splats_tpu.train import optim, strategy

    params = {k[2:]: jnp.asarray(v) for k, v in inputs.items()
              if k.startswith("p_")}
    cfg = rade_gs.RadeGSConfig(
        sh_degree=0, background="black",
        render=RenderOptions(tile_capacity=128, max_intersections=1 << 13),
        use_depth_normal_loss=True, regularization_from_iter=0)
    if capture:
        opt = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g),
                                  g))
    else:
        opt = optim.make_optimizer(optim.RADE_GS_GROUPS,
                                   optim.default_labels(params))
    opt_state = opt.init(params)
    mesh = pmesh.make_mesh(n_data, n_gauss,
                           devices=jax.devices()[:n_data * n_gauss])
    step = make_sharded_train_step(
        mesh, opt, cfg, SIZE, SIZE, CAP, jax.eval_shape(lambda: opt_state),
        reg_active=True, tile_sharded=tile)
    alive = jnp.asarray(inputs["alive"])
    cams = CameraBatch(K=jnp.asarray(inputs["K"]),
                       c2w=jnp.asarray(inputs["c2w"]))
    images = jnp.asarray(inputs["images"])
    strat = strategy.init_state(CAP)
    key = jax.random.PRNGKey(5)
    for i in range(steps):
        params, opt_state, strat, metrics = step(
            params, alive, opt_state, strat, cams, images, i, key)
    if capture:
        return {k: np.asarray(v) for k, v in opt_state.items()}
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in strat._asdict().items()},
            {k: float(v) for k, v in metrics.items()})


def _jax_routed_render(inputs, send_cap):
    """JAX ``render_tile_sharded`` over four bands on a (1, 4) mesh, the
    routed-render scene carried across: (color, depth, alpha, spilled)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from collab_splats_tpu.core.cameras import Camera
    from collab_splats_tpu.core.options import RenderOptions
    from collab_splats_tpu.core.projection import project_gaussians
    from collab_splats_tpu.core.sh import sh0_to_rgb
    from collab_splats_tpu.parallel import mesh as jmesh
    from collab_splats_tpu.parallel.tiles import render_tile_sharded

    t = {k[2:]: jnp.asarray(v) for k, v in inputs.items()
         if k.startswith("t_")}
    cam = Camera(K=jnp.asarray(inputs["tK"]), c2w=jnp.asarray(inputs["tc2w"]),
                 width=TILE_SIZE, height=TILE_SIZE)
    opts = RenderOptions(tile_capacity=128, max_intersections=1 << 13,
                         exact_binning=True)
    mesh = jmesh.make_mesh(1, 4, devices=jax.devices()[:4])

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("gauss"),) * 5,
                       out_specs=(P(), P(), P(), P()), check_vma=False)
    def run(m, q, s, o, c):
        proj = project_gaussians(
            m, q, s, cam.viewmat(), cam.K, TILE_SIZE, TILE_SIZE,
            eps2d=opts.eps2d, near_plane=opts.near_plane,
            far_plane=opts.far_plane, radius_clip=opts.radius_clip,
            opacities=o)
        out, _, _ = render_tile_sharded(proj, o, c, cam, opts, 4, send_cap)
        return out.color, out.depth, out.alpha, out.spilled

    out = jax.jit(run)(t["means"], t["quats"], jnp.exp(t["scales"]),
                       jax.nn.sigmoid(t["opacities"][:, 0]),
                       sh0_to_rgb(t["features_dc"]))
    return [np.asarray(x) for x in out]


def _single_device_gradients(inputs, device="cpu"):
    """The port's single-device gradient (``get_outputs(training=True)``
    + ``get_loss``), averaged over the two cameras, dead rows zero."""
    from collab_splats_tpu_torch.core.cameras import camera_from_numpy
    from collab_splats_tpu_torch.models import rade_gs

    cfg = _port_config()
    alive = torch.from_numpy(inputs["alive"]).to(device)
    total = None
    for K, c2w, image in zip(inputs["K"], inputs["c2w"], inputs["images"]):
        p = {k[2:]: torch.from_numpy(v).to(device).requires_grad_(True)
             for k, v in inputs.items() if k.startswith("p_")}
        cam = camera_from_numpy(K, c2w, SIZE, SIZE, device=device)
        out, _ = rade_gs.get_outputs(p, alive, cam, 0, cfg, training=True,
                                     compute_error_maps=True)
        loss, _ = rade_gs.get_loss(out, torch.from_numpy(image).to(device),
                                   p, alive, 0, cfg, reg_active=True)
        g = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        g = {k: (torch.zeros_like(v) if gi is None else gi)
             * alive.float().reshape((-1,) + (1,) * (v.dim() - 1))
             for (k, v), gi in zip(p.items(), g)}
        total = g if total is None else {k: total[k] + g[k] for k in g}
    return {k: (v / 2).cpu().numpy() for k, v in total.items()}


def start_ranks(tmp, inputs, device):
    """The four rank processes of :func:`_worker` on ``device``."""
    np.savez(tmp / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--init",
         f"file://{tmp / 'init'}", "--inputs", str(tmp / "inputs.npz"),
         "--out", str(tmp / "out.npz"), "--device", device],
        env=dict(env, LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(RANKS)]


def finish_ranks(tmp, procs):
    """Waits for the ranks (killing them on a timeout) and returns rank
    0's results."""
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=WORKER_TIMEOUT)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Starts the four ranks on gloo, runs the JAX references meanwhile,
    and returns (the ranks' results, the references, the inputs)."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = make_inputs()
    procs = start_ranks(tmp, inputs, "cpu")
    try:
        refs = {"adam": _jax_run(inputs, 2, 2, STEPS),
                "tile": _jax_run(inputs, 2, 2, STEPS, tile=True),
                "render": _jax_routed_render(inputs, 512 // 4 * 4),
                "grads": _jax_run(inputs, 2, 2, 1, capture=True),
                "single": _single_device_gradients(inputs)}
        import jax

        from __graft_entry__ import _run_sharded_step
        from collab_splats_tpu.parallel import mesh as jmesh

        refs["graft_loss"], _ = _run_sharded_step(
            jmesh.make_mesh(1, 2, devices=jax.devices()[:2]))
    finally:
        r = finish_ranks(tmp, procs)
    return r, refs, inputs


# ------------------------------------------------------------------ checks
# Port-side checks of the ranks' results, run on gloo and on NCCL.
def close(a, b, what, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def check_layouts(r):
    """(2, 2) against (2, 1): a pure layout change."""
    np.testing.assert_allclose(r["ag_metrics"][:, 0], r["one_metrics"][:, 0],
                               rtol=1e-5)
    close(r["ag_means"], r["one_means"], "means")
    close(r["ag_grad_accum"], r["one_grad_accum"], "grad_accum", 1e-3, 1e-7)
    np.testing.assert_array_equal(r["ag_count"], r["one_count"])


def check_single_device_gradients(r, single):
    """The (2, 2) step's pre-Adam gradients against the single-device
    gradient."""
    for k, ref in single.items():
        if ref.size:
            np.testing.assert_allclose(r[f"grad_{k}"], ref, rtol=5e-4,
                                       atol=5e-5 * np.abs(ref).max(),
                                       err_msg=k)


def check_tile_sharded(r):
    np.testing.assert_allclose(r["tile_metrics"][:, 0],
                               r["ag_metrics"][:, 0], rtol=1e-4)
    np.testing.assert_array_equal(r["tile_metrics"][:, 2],
                                  r["ag_metrics"][:, 2])
    close(r["tile_means"], r["ag_means"], "means")
    close(r["tile_grad_accum"], r["ag_grad_accum"], "grad_accum", 1e-3,
          1e-7)
    np.testing.assert_array_equal(r["tile_count"], r["ag_count"])


def check_send_cap(r, inputs):
    """A small slab drops rows (counted) and still trains."""
    assert r["cap_metrics"][0, 2] > 0
    assert np.isfinite(r["cap_metrics"]).all()
    assert np.abs(r["cap_means"] - inputs["p_means"]).max() > 0
    assert r["render8_spilled"] > 0
    assert np.isfinite(r["render8_color"]).all()


def _tile_scene(inputs, device, n=TILE_N):
    from collab_splats_tpu_torch.core.cameras import camera_from_numpy
    from collab_splats_tpu_torch.core.options import RenderOptions
    from collab_splats_tpu_torch.core.sh import sh0_to_rgb

    t = {k[2:]: torch.from_numpy(v[:n]).to(device)
         for k, v in inputs.items() if k.startswith("t_")}
    cam = camera_from_numpy(inputs["tK"], inputs["tc2w"], TILE_SIZE,
                            TILE_SIZE, device=device)
    opts = RenderOptions(tile_capacity=128, max_intersections=1 << 13,
                         exact_binning=True)
    return (t["means"], t["quats"], torch.exp(t["scales"]),
            torch.sigmoid(t["opacities"][:, 0]),
            sh0_to_rgb(t["features_dc"])), cam, opts


def check_routed_render(r, inputs, device="cpu"):
    """Four bands on a (1, 4) mesh against the single-device render."""
    from collab_splats_tpu_torch.ops.rasterize import render_tiled

    args, cam, opts = _tile_scene(inputs, device)
    ref, _ = render_tiled(*args, cam, opts)
    assert int(r["render_spilled"]) == int(ref.spilled)
    np.testing.assert_allclose(r["render_color"], ref.color.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["render_depth"], ref.depth.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r["render_alpha"], ref.alpha.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


def check_gradients_reach_every_shard(r, inputs, device="cpu"):
    from collab_splats_tpu_torch.ops.rasterize import render_tiled

    gm = r["rgrad_means"]
    for sh in range(4):
        assert np.abs(gm[sh * 64:(sh + 1) * 64]).max() > 0
    (m, q, s, o, c), cam, opts = _tile_scene(inputs, device, 256)
    means = m.clone().requires_grad_(True)
    colors = c.clone().requires_grad_(True)
    out, _ = render_tiled(means, q, s, o, colors, cam, opts)
    g = torch.autograd.grad(torch.sum(out.color) + torch.sum(out.depth),
                            [means, colors])
    # tests/test_tile_sharded.py's bounds.
    np.testing.assert_allclose(gm, g[0].cpu().numpy(), rtol=2e-2, atol=1e-4)
    np.testing.assert_allclose(r["rgrad_colors"], g[1].cpu().numpy(),
                               rtol=2e-2, atol=1e-4)


def check_slab_rows(r):
    """G * send_cap = 256 candidate rows per member of 512 Gaussians."""
    np.testing.assert_array_equal(r["slab_rows"], [4 * 64] * 3)
    assert 4 * 64 < TILE_N


def check_refine(r):
    assert r["ref22_counts"][0] + r["ref22_counts"][1] > 0
    np.testing.assert_array_equal(r["ref22_counts"], r["ref21_counts"])
    np.testing.assert_array_equal(r["ref22_alive"], r["ref21_alive"])
    close(r["ref22_means"], r["ref21_means"], "means")
    assert r["ref22_metrics"][-1, 0] == pytest.approx(
        r["ref21_metrics"][-1, 0], rel=1e-4)


def check_repeated(r):
    for k in ("means", "grad_accum", "count", "max_radii", "moments",
              "metrics"):
        np.testing.assert_array_equal(r[f"ag_{k}"], r[f"ag_again_{k}"])


def check_data_rows(r):
    """After the gradient mean over ``data`` every row applies the same
    Adam update: parameters and moments equal bit for bit."""
    for k in ("ag", "tile", "one", "ref22"):
        assert bool(r[f"{k}_rows_equal"]), k


# ------------------------------------------------------------------- tests
def test_layouts_agree(results):
    check_layouts(results[0])


def test_matches_jax(results):
    """The (2, 2) step against JAX's at the same mesh shape."""
    r, refs, _ = results
    params, strat, metrics = refs["adam"]
    assert metrics["spilled"] == 0 and r["ag_metrics"][-1, 2] == 0
    assert r["ag_metrics"][-1, 0] == pytest.approx(metrics["loss"], rel=1e-5)
    assert r["ag_metrics"][-1, 1] == pytest.approx(metrics["psnr"], rel=1e-5)
    close(r["ag_means"], params["means"], "means")
    close(r["ag_grad_accum"], strat["grad_accum"], "grad_accum", 1e-3, 1e-7)
    np.testing.assert_array_equal(r["ag_count"], strat["count"])
    np.testing.assert_array_equal(r["ag_max_radii"], strat["max_radii"])


def test_tile_sharded_matches_jax(results):
    """The (2, 2) tile-sharded step against JAX's at the same mesh shape.
    The port sends kept slab rows in index order and JAX in depth order;
    on this scene, which spills nothing, the two give the same step."""
    r, refs, _ = results
    params, strat, metrics = refs["tile"]
    assert metrics["spilled"] == 0 and r["tile_metrics"][-1, 2] == 0
    assert r["tile_metrics"][-1, 0] == pytest.approx(metrics["loss"],
                                                     rel=1e-4)
    close(r["tile_means"], params["means"], "means")
    close(r["tile_grad_accum"], strat["grad_accum"], "grad_accum", 1e-3,
          1e-7)
    np.testing.assert_array_equal(r["tile_count"], strat["count"])


def test_routed_render_matches_jax(results):
    """``route_to_bands`` + the band render over four bands against JAX's
    ``render_tile_sharded`` on the same scene and mesh shape."""
    r, refs, _ = results
    color, depth, alpha, spilled = refs["render"]
    assert int(r["render_spilled"]) == int(spilled)
    np.testing.assert_allclose(r["render_color"], color, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r["render_depth"], depth, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r["render_alpha"], alpha, rtol=1e-5,
                               atol=1e-6)


def test_gradients_are_the_single_device_ones(results):
    """The port's pre-Adam gradients are the single-device gradient; JAX's
    all-gather step's are G = 2 times it."""
    r, refs, _ = results
    check_single_device_gradients(r, refs["single"])
    for k, ref in refs["single"].items():
        if ref.size:
            np.testing.assert_allclose(refs["grads"][k], 2.0 * ref,
                                       rtol=5e-4,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=f"JAX {k}")


def test_tile_sharded_matches_allgather(results):
    check_tile_sharded(results[0])


def test_send_cap_spills_but_stays_finite(results):
    check_send_cap(results[0], results[2])


def test_routed_render_matches_single_device(results):
    check_routed_render(results[0], results[2])


def test_gradients_flow_to_all_shards(results):
    check_gradients_reach_every_shard(results[0], results[2])


def test_slab_rows_scale_with_send_cap(results):
    check_slab_rows(results[0])


def test_refine_layout_invariance(results):
    check_refine(results[0])


def test_repeated_steps_are_bit_identical(results):
    check_repeated(results[0])


def test_data_rows_hold_the_same_state(results):
    check_data_rows(results[0])


def test_step_needs_one_camera_per_data_row(results):
    assert bool(results[0]["raises_camera_count"])


def test_two_rank_loss_matches_graft_entry(results):
    """__graft_entry__._run_sharded_step on a (1, 2) mesh, its scene
    carried across."""
    r, refs, _ = results
    np.testing.assert_allclose(float(r["graft_loss"]), refs["graft_loss"],
                               rtol=1e-4)
    assert float(r["graft_delta"]) > 0


@pytest.mark.card
def test_nccl_on_four_cards(tmp_path):
    """The same ranks on four CUDA cards under NCCL, held to every
    port-side check (the kernels run there, their plain versions here)."""
    if torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} CUDA cards")
    from collab_splats_tpu_torch.ops.cuda import build

    build.build_all()
    inputs = make_inputs(graft=False)
    r = finish_ranks(tmp_path, start_ranks(tmp_path, inputs, "cuda"))
    check_layouts(r)
    check_single_device_gradients(r, _single_device_gradients(inputs,
                                                              "cuda"))
    check_tile_sharded(r)
    check_send_cap(r, inputs)
    check_routed_render(r, inputs, "cuda")
    check_gradients_reach_every_shard(r, inputs, "cuda")
    check_slab_rows(r)
    check_refine(r)
    check_repeated(r)
    check_data_rows(r)
    assert bool(r["raises_camera_count"])


def test_mesh_entry_points_refuse(monkeypatch):
    from collab_splats_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError, match="num_processes"):
        pmesh.initialize_distributed("localhost:1", device_type="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        pmesh.make_mesh(1, 1, device_type="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.initialize_distributed()
    # No launcher environment and no arguments: a single process.
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.initialize_distributed(device_type="cpu") == 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    _worker(a.rank, a.init, a.inputs, a.out, a.device)

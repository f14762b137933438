"""The train loop: ``Trainer.train_one_step()`` of the configuration's
method, in a closed loop, on the traffic's seeded scene.

Set-up builds one trainer from the seed at the traffic's step (the
second half of the 30,000-step schedule: full resolution, SH degree 3,
the depth-normal term on, cull-only refines), drives its first
``check_steps`` steps through the window's own call (they warm every
shape up) and keeps what the check needs of them: each step's loss, each
leaf's first gradient as Adam holds it, each leaf's change, and the
alive mask, since the checked steps cross a cull-only refine.  The window
then runs that same trainer for the run's seconds.  Once it has closed,
the trainer is freed and the plain reference follows the checked steps
from the same seeded inputs.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict

import numpy as np
import torch

from benchlib import scene, trace, window
from loops import common
from reference import render as R
from reference import train as RT
from reference.precision import Products

# Leaves whose reference gradient is below this share of the median
# leaf's move by round-off alone under Adam: left out of the change.
STILL_LEAF = 1e-3


def make_inputs(seed: int, cfg: dict, traffic: dict, device) -> dict:
    """The seeded inputs of a run, shared by the program and the
    reference: the training start, its alive mask, the camera rig, the
    images, and for rade-features the towers' maps and the decoder."""
    model = cfg["model"]
    latent = model["latent_dim"]
    out = {}
    out["params"] = scene.gaussian_table(
        seed, traffic["n_alive"], traffic["capacity"], model["sh_degree"],
        latent, traffic["extent"], traffic["scale_range"], device,
        perturbed=True)
    out["alive"] = scene.alive_mask(traffic["n_alive"], traffic["capacity"],
                                    device)
    out["rig"] = scene.orbit_rig(traffic["views"], traffic["radius"],
                                 traffic["width"], traffic["height"],
                                 traffic["focal"])
    out["images"] = scene.smooth_images(seed, traffic["views"],
                                        traffic["height"], traffic["width"],
                                        device)
    out["targets"] = out["decoder"] = None
    if latent:
        dims = model["feature_dims"]
        out["targets"] = scene.feature_maps(seed, traffic["views"], dims,
                                            device)
        out["decoder"] = scene.decoder_weights(
            seed, latent, model["mlp_hidden_dim"], dims, device)
    return out


def count_key(name: str) -> str:
    return f"opt/.inner_states/['{name}']/.inner_state/[0]/.count"


def build_trainer(ctx, inp: dict):
    """The program's trainer for this run, at the traffic's step."""
    from collab_splats_tpu_torch.core.cameras import make_camera
    from collab_splats_tpu_torch.features import decoder as decoder_lib
    from collab_splats_tpu_torch.pipeline.methods import get_method
    from collab_splats_tpu_torch.train.trainer import Trainer

    cfg, traffic = ctx.config, ctx.traffic
    spec = get_method(cfg["method"])
    kwargs = dict(cfg["method_kwargs"])
    if "feature_dims" in kwargs:
        kwargs["feature_dims"] = tuple(
            (n, tuple(d)) for n, d in sorted(kwargs["feature_dims"].items()))
    tcfg = spec.make_trainer_config(**kwargs)
    tcfg = dataclasses.replace(tcfg, seed=ctx.trainer_seed)
    cams = [make_camera(float(r["K"][0, 0]), float(r["K"][1, 1]),
                        float(r["K"][0, 2]), float(r["K"][1, 2]),
                        r["width"], r["height"], r["c2w"], device=ctx.device)
            for r in inp["rig"]]
    decoder = None
    if inp["decoder"] is not None:
        model = tcfg.model
        decoder = decoder_lib.TwoLayerDecoder(
            model.latent_dim, model.mlp_hidden_dim,
            model.feature_dims_dict(), device=ctx.device)
        with torch.no_grad():
            for k, t in decoder_lib.decoder_tensors(decoder).items():
                t.copy_(inp["decoder"][k])
    tr = Trainer(tcfg, cams, list(inp["images"]), inp["params"],
                 inp["alive"], groups=spec.groups,
                 features=inp["targets"], decoder=decoder,
                 device=ctx.device)
    common.check_config(tcfg, spec.groups, tr.optimizer, cfg)
    start = traffic["start_step"]
    tr.step = start
    tr.load_state_numpy({count_key(g["name"]): np.int64(start)
                         for g in tr.optimizer.param_groups})
    return tr


def _leaves(tr) -> Dict[str, torch.Tensor]:
    from collab_splats_tpu_torch.features import decoder as decoder_lib

    out = dict(tr.params)
    if tr.decoder is not None:
        for k, t in decoder_lib.decoder_tensors(tr.decoder).items():
            out["decoder/" + k] = t
    return out


def checked_steps(tr, n: int):
    """Run the first ``n`` steps; return (their losses, each leaf's first
    gradient norm as Adam's first moment holds it, each leaf's change
    norm after the n steps, the alive mask after them)."""
    leaves = _leaves(tr)
    init = {k: v.detach().clone() for k, v in leaves.items()}
    beta1 = tr.optimizer.param_groups[0]["betas"][0]
    losses, first = [], None
    for j in range(n):
        losses.append(tr.train_one_step()["loss"])
        if j == 0:
            leaves = _leaves(tr)
            first = {k: float(torch.linalg.vector_norm(
                tr.optimizer.state[p]["exp_avg"] / (1.0 - beta1)))
                for k, p in leaves.items()}
    leaves = _leaves(tr)
    change = {k: float(torch.linalg.vector_norm(leaves[k].detach() - init[k]))
              for k in init}
    return losses, first, change, tr.alive.clone()


def reference_readings(ctx, prec: Products, n: int, half: bool = False,
                       cull: bool = True):
    """The plain reference over the first ``n`` steps from the same
    seeded inputs: (losses, each leaf's first gradient norm, each leaf's
    change norm, the alive mask after them).  ``half`` takes the loss
    over the top half of the image only, ``cull=False`` leaves the
    refine's cull out: faults for the check to catch."""
    traffic, model = ctx.traffic, ctx.config["model"]
    inp = make_inputs(ctx.seed, ctx.config, traffic, ctx.device)
    steps = [traffic["start_step"] + j for j in range(n)]
    views = [scene.camera_draw(ctx.trainer_seed, s, traffic["views"])
             for s in steps]
    bgs = [torch.rand(3, generator=step_generator(ctx.trainer_seed, s,
                                                  ctx.device),
                      device=ctx.device) for s in steps]
    losses, first, final, alive = RT.train_steps(
        inp["params"], inp["alive"], inp["rig"], inp["images"],
        inp["targets"], inp["decoder"], steps, views, bgs, model,
        ctx.config["optimizer"], traffic["start_step"], prec,
        ctx.config["strategy"], ctx.config["trainer"], half=half, cull=cull)
    init = dict(inp["params"])
    for k, v in (inp["decoder"] or {}).items():
        init["decoder/" + k] = v
    gref = {k: float(torch.linalg.vector_norm(g)) for k, g in first.items()}
    cref = {k: float(torch.linalg.vector_norm(final[k] - init[k]))
            for k in init}
    return losses, gref, cref, alive


def numbers(got, ref) -> Dict[str, float]:
    """The four numbers of readings ``got`` against the reference's:
    the worst step's relative loss gap, the worst leaf's gap of the
    first gradient's norm and of the change's norm (leaves that the
    reference barely moves left out of the change), and the rows whose
    alive flag differs after the checked steps, which cross a refine."""
    losses, gref, cref, alive = ref
    gvals = sorted(gref.values())
    gmed = gvals[len(gvals) // 2]
    moving = [k for k in gref if gref[k] >= STILL_LEAF * gmed]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got[0], losses)),
        "grad_gap": common.gap_by_leaf(got[1], gref),
        "change_gap": common.gap_by_leaf(got[2], cref, moving),
        "alive_mismatch": float((got[3] != alive).sum()),
    }


def step_generator(trainer_seed: int, step: int, device) -> torch.Generator:
    """The step's background stream (a frozen copy of the trainer's
    ``step_generator`` with salt 1)."""
    return torch.Generator(device=device).manual_seed(
        (trainer_seed * 1_000_003 + 4 * step + 1) % (1 << 62))


def setup(ctx):
    """(trainer, the checked steps' readings)."""
    traffic = ctx.traffic
    ctx.trainer_seed = scene.trainer_seed(ctx.seed, traffic["views"],
                                          traffic["start_step"],
                                          traffic["check_steps"])
    inp = make_inputs(ctx.seed, ctx.config, traffic, ctx.device)
    ctx.sync()
    ctx.mark("inputs")
    tr = build_trainer(ctx, inp)
    del inp
    ctx.sync()
    ctx.mark("trainer")
    prog = checked_steps(tr, traffic["check_steps"])
    ctx.sync()
    ctx.mark("checked_steps")
    return tr, prog


def run(ctx) -> dict:
    tr, prog = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    steps, failed = 0, 0
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        m = tr.train_one_step()
        steps += 1
        failed += int(m["nonfinite_grad"] > 0)
        if time.perf_counter() >= end:
            break
    ctx.sync()
    wall = time.perf_counter() - start
    step_ms = window.ms_per_unit(wall, steps)
    out = {"attempted": steps, "failed": failed,
           "e2e": {"setup_s": setup_s, "step_ms": step_ms}}
    if ctx.trace:
        out.update(traced(ctx, tr))
    out["memory_peak_bytes"] = ctx.memory_peak()
    del tr
    gc.collect()
    ctx.free()
    if "work" in out:
        out["layer"] = layer_inputs(ctx, out.pop("work"), out.pop("summary"),
                                    step_ms / 1e3)
    ref = reference_readings(ctx, Products(False), len(prog[0]))
    out["numbers"] = numbers(prog, ref)
    return out


def traced(ctx, tr) -> dict:
    """Trace ``trace_steps`` steps that hold no refine, after keeping a
    copy of their inputs for the counts."""
    from torch.profiler import ProfilerActivity, profile, record_function

    k = ctx.traffic["trace_steps"]
    scfg = tr.config.strategy
    while any(scfg.is_refine_step(tr.step + 1 + j) for j in range(k)):
        tr.train_one_step()
    steps = [tr.step + j for j in range(k)]
    params = {kk: v.detach().clone() for kk, v in tr.params.items()}
    alive = tr.alive.clone()
    ctx.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for _ in range(k):
                tr.train_one_step()
            ctx.sync()
    summary = trace.summarize(trace.from_profiler(prof))
    return {"summary": summary, "work": (params, alive, steps)}


def layer_inputs(ctx, work, summary, unit_s: float) -> dict:
    """What the per-layer readers read: the trace's summary per step, and
    the counts of the traced steps' work on the reference binning."""
    params, alive, steps = work
    traffic, model = ctx.traffic, ctx.config["model"]
    bounds: Dict[str, float] = {}
    ops = 0.0
    per_row = sum(int(np.prod(v.shape[1:])) for v in params.values())
    dec = 0
    if model["latent_dim"]:
        dims = model["feature_dims"]
        h = model["mlp_hidden_dim"]
        dec = model["latent_dim"] * h + h + sum(
            h * c + c for c, _, _ in dims.values())
    rig = scene.orbit_rig(traffic["views"], traffic["radius"],
                          traffic["width"], traffic["height"],
                          traffic["focal"])
    for s in steps:
        view = scene.camera_draw(ctx.trainer_seed, s, traffic["views"])
        cam = R.camera(rig[view], ctx.device)
        w = common.render_work(params, alive, cam, s, model)
        for name, b in common.kernel_bounds(w).items():
            bounds[name] = bounds.get(name, 0.0) + b
        ops += common.train_ops(w, w.alive * per_row + dec, model,
                                cam.height, cam.width)
    return {"kind": "train", "units": len(steps), "unit_s": unit_s,
            "summary": summary, "bound_s": bounds, "useful_ops": ops}

"""The densify loop: ``Trainer.train_one_step()`` of the configuration's
method inside splatfacto's densification window, in a closed loop, on the
train loop's seeded scene.

Set-up builds the trainer as the train loop does (``loops/train.py``), at
the traffic's step in the first half of the 30,000-step schedule (full
resolution, SH degree 3, the depth-normal term off, refines that
duplicate, split and cull every 100 steps, capacity growth when the
trainer decides), keeps a snapshot of it (parameters, Adam's state, the
strategy's statistics, the capacity and the step), and drives its first
``check_steps`` steps through the window's own call.  They cross a
densifying refine; its inputs and result are recorded on the way (the
statistics, the table, and the split children's draws, which the tap
draws from the trainer's own stream and hands to the refine).  The
trainer is then put back to the snapshot, and the window runs it for the
run's seconds, putting it back every ``restart_every`` steps, so that
every window runs the same sequence of steps whatever the program's
speed.  Once it has closed, the trainer is freed; the plain reference
follows the checked steps from the same seeded inputs, its refine
(``reference/densify.py``) on its own table with the program's
statistics and draws, and the program's refine is held to the
reference's on the program's own inputs.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Dict, List

import torch

from benchlib import scene, trace, window
from loops import train as T
from reference import densify as RD
from reference import render as R
from reference import train as RT
from reference.precision import Products


@contextlib.contextmanager
def tapped(record: List[dict]):
    """While open, every refine the program runs appends its inputs and
    result to ``record``."""
    from collab_splats_tpu_torch.train import strategy

    real = strategy.refine

    def tap(params, alive, state, cfg, generator=None, noise=None, **kw):
        if noise is None:
            noise = strategy.split_noise(generator, cfg.n_split_samples,
                                         alive.shape[0], alive.device)
        rec = {"params": {k: v.detach().clone() for k, v in params.items()},
               "alive": alive.clone(),
               "state": [x.clone() for x in state], "noise": noise.clone()}
        res = real(params, alive, state, cfg, generator=generator,
                   noise=noise, **kw)
        rec["result"] = {"params": {k: v.detach().clone()
                                    for k, v in res.params.items()},
                         "alive": res.alive.clone(),
                         "written": res.written.clone(),
                         "n_dup": res.n_dup, "n_split": res.n_split,
                         "n_cull": res.n_cull}
        record.append(rec)
        return res

    strategy.refine = tap
    try:
        yield
    finally:
        strategy.refine = real


def setup(ctx):
    """(trainer at the snapshot, the snapshot, the checked steps'
    readings, the checked steps' refines)."""
    traffic = ctx.traffic
    ctx.trainer_seed = scene.trainer_seed(ctx.seed, traffic["views"],
                                          traffic["start_step"],
                                          traffic["check_steps"])
    inp = T.make_inputs(ctx.seed, ctx.config, traffic, ctx.device)
    ctx.sync()
    ctx.mark("inputs")
    tr = T.build_trainer(ctx, inp)
    del inp
    snapshot = tr.state()
    ctx.sync()
    ctx.mark("trainer")
    refines: List[dict] = []
    with tapped(refines):
        prog = T.checked_steps(tr, traffic["check_steps"])
    tr.load_state(snapshot)
    ctx.sync()
    ctx.mark("checked_steps")
    return tr, snapshot, prog, refines


def refine_steps(ctx, n: int) -> List[int]:
    """The refine steps among the first ``n`` steps from the traffic's
    start: the step counts at which a refine runs."""
    strat, start = ctx.config["strategy"], ctx.traffic["start_step"]
    return [s for s in range(start + 1, start + n + 1)
            if s > strat["warmup_length"] and s % strat["refine_every"] == 0
            and s < ctx.config["trainer"]["max_iterations"]]


def refine_of(rec: dict, step: int, ctx) -> RD.Refined:
    """The reference's refine at ``step`` of a recorded refine's inputs."""
    grad, count, radii = rec["state"]
    return RD.refine(rec["params"], rec["alive"], grad, count, radii,
                     rec["noise"], step, ctx.config["strategy"],
                     ctx.config["trainer"]["scene_scale"],
                     ctx.traffic["views"])


def reference_readings(ctx, refines: List[dict], n: int, prec: Products,
                       densify: bool = True):
    """The plain reference over the checked steps from the same seeded
    inputs, with the refines that fall among them, each
    ``reference/densify.py``'s on the reference's own table with the
    program's recorded statistics and draws, the written rows' Adam
    moments zeroed (``densify=False`` only culls: a fault for the
    check).  Returns what ``loops/train.py::numbers`` reads."""
    traffic, model = ctx.traffic, ctx.config["model"]
    inp = T.make_inputs(ctx.seed, ctx.config, traffic, ctx.device)
    steps = [traffic["start_step"] + j for j in range(n)]
    state = {k: v.detach().clone() for k, v in inp["params"].items()}
    alive = inp["alive"]
    opt = RT.Adam(dict(ctx.config["optimizer"]["groups"]),
                  tuple(ctx.config["optimizer"]["betas"]),
                  traffic["start_step"])
    strat = ctx.config["strategy"]
    pending = list(refines)
    at = refine_steps(ctx, n)
    losses, first = [], None
    for step in steps:
        view = scene.camera_draw(ctx.trainer_seed, step, traffic["views"])
        bg = torch.rand(3, generator=T.step_generator(ctx.trainer_seed,
                                                      step, ctx.device),
                        device=ctx.device)
        cam = R.camera(inp["rig"][view], ctx.device)
        loss, grads = RT.loss_and_grads(state, alive, cam,
                                        inp["images"][view], None, None, bg,
                                        step, model, prec)
        losses.append(loss)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        if all(bool(torch.isfinite(g).all()) for g in grads.values()):
            opt.step(state, grads)
        s = step + 1
        if s not in at:
            continue
        rec = pending.pop(0)
        if rec["alive"].shape != alive.shape:
            raise RuntimeError("the program grew its table inside the "
                               "checked steps")
        grad, count, radii = rec["state"]
        ref = RD.refine(state, alive, grad, count, radii, rec["noise"], s,
                        strat if densify else dict(strat, stop_split_at=0),
                        ctx.config["trainer"]["scene_scale"],
                        traffic["views"])
        state, alive = ref.params, ref.alive
        for moments in (opt.m, opt.v):
            for k in moments:
                moments[k][ref.written] = 0.0
    init = dict(inp["params"])
    gref = {k: float(torch.linalg.vector_norm(g)) for k, g in first.items()}
    cref = {k: float(torch.linalg.vector_norm(state[k] - init[k]))
            for k in init}
    return losses, gref, cref, alive


def numbers(ctx, prog, refines: List[dict], ref) -> Dict[str, float]:
    """The train cells' four numbers and ``refine_mismatch``: the rows on
    which each of the checked steps' refines differs from the
    reference's refine of the program's own inputs."""
    out = T.numbers(prog, ref)
    out["refine_mismatch"] = sum(
        RD.mismatch(rec["result"], refine_of(rec, step, ctx))
        for rec, step in zip(refines, refine_steps(ctx, len(prog[0]))))
    return out


def run(ctx) -> dict:
    tr, snapshot, prog, refines = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    traffic = ctx.traffic
    start, every = traffic["start_step"], traffic["restart_every"]
    n = len(prog[0])
    if not refines or len(refines) != len(refine_steps(ctx, n)):
        raise RuntimeError(f"the checked steps ran {len(refines)} refines, "
                           f"the schedule has {refine_steps(ctx, n)}")
    steps, failed, refined, grown = 0, 0, [], []
    begin = time.perf_counter()
    end = begin + ctx.seconds
    while True:
        if tr.step >= start + every:
            tr.load_state(snapshot)
        cap = tr.alive.shape[0]
        m = tr.train_one_step()
        steps += 1
        failed += int(m["nonfinite_grad"] > 0)
        if "refine_dup" in m and steps <= every:
            refined.append((tr.step, m["refine_dup"], m["refine_split"],
                            m["refine_cull"], m["num_gaussians"]))
        if tr.alive.shape[0] != cap:
            grown.append((tr.step, tr.alive.shape[0]))
        if time.perf_counter() >= end:
            break
    ctx.sync()
    wall = time.perf_counter() - begin
    step_ms = window.ms_per_unit(wall, steps)
    print(f"window: {steps} steps from {start}, restarted every {every}; "
          "refines of the first pass (step, duplicated, split, culled, "
          f"alive): {refined}; capacity growths (step, rows): {grown}",
          file=sys.stderr)
    out = {"attempted": steps, "failed": failed,
           "e2e": {"setup_s": setup_s, "step_ms": step_ms}}
    if ctx.trace:
        out["layer"] = traced(ctx, tr, snapshot, step_ms / 1e3)
    out["memory_peak_bytes"] = ctx.memory_peak()
    del tr, snapshot
    gc.collect()
    ctx.free()
    ref = reference_readings(ctx, refines, n, Products(False))
    out["numbers"] = numbers(ctx, prog, refines, ref)
    return out


def traced(ctx, tr, snapshot, unit_s: float) -> dict:
    """From the snapshot, trace ``trace_steps`` steps from the step
    ``trace_from``, across a densifying refine."""
    from collab_splats_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile, record_function

    k = ctx.traffic["trace_steps"]
    tr.load_state(snapshot)
    while tr.step < ctx.traffic["trace_from"]:
        tr.train_one_step()
    ctx.sync()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for _ in range(k):
                tr.train_one_step()
            ctx.sync()
    summary = trace.summarize(trace.from_profiler(prof))
    return {"kind": "densify", "units": k, "unit_s": unit_s,
            "summary": summary, "bound_s": {}, "useful_ops": 0.0}

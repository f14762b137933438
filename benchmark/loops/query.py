"""The query loop: one text query after another over a rade-features
scene, closed loop, one client.

A unit renders the next view in a seeded order with
``rade_features.get_outputs(training=False)``, scores it with
``rade_features.similarity_map`` against the next seeded positive
embedding and the seeded negatives, and reads the [H, W, 1] map to the
host.  Set-up builds the seeded scene (the train mix's table with seeded
latents), the cameras, the decoder and the embeddings, and answers the
first ``check_queries`` queries, which warm every shape up and whose maps
the check keeps.  Once the window has closed, the program's scene is freed
and the plain reference (``reference/query.py``) answers the checked
queries from the same seeded inputs.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchlib import scene, trace, window
from reference import query as RQ
from reference import render as R
from reference.precision import Products


def make_inputs(seed: int, cfg: dict, traffic: dict, device) -> dict:
    """The seeded scene (latents drawn normal), rig, decoder weights and
    embeddings, [positives ++ negatives, C] unit rows."""
    model = cfg["model"]
    params = scene.gaussian_table(
        seed, traffic["n_alive"], traffic["capacity"], model["sh_degree"],
        model["latent_dim"], traffic["extent"], traffic["scale_range"],
        device, perturbed=True)
    g = scene.generator(seed, 13, device)
    n = traffic["n_alive"]
    params["distill_features"][:n] = torch.randn(
        (n, model["latent_dim"]), generator=g, device=device)
    main = model["main_feature_name"]
    dims = model["feature_dims"]
    emb = torch.randn((traffic["positives"] + traffic["negatives"],
                       dims[main][0]), generator=g, device=device)
    return {"params": params,
            "alive": scene.alive_mask(n, traffic["capacity"], device),
            "rig": scene.orbit_rig(traffic["views"], traffic["radius"],
                                   traffic["width"], traffic["height"],
                                   traffic["focal"]),
            "decoder": scene.decoder_weights(seed, model["latent_dim"],
                                             model["mlp_hidden_dim"], dims,
                                             device),
            "emb": emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)}


def check_model(model, cfg: dict) -> None:
    """Raise unless the program's model configuration holds the values
    the configuration's file states."""
    bad = []
    for key, want in cfg["model"].items():
        if key == "render":
            for rk, rw in want.items():
                if getattr(model.render, rk) != rw:
                    bad.append(f"render.{rk}")
            continue
        got = getattr(model, key)
        if key == "feature_dims":
            got = {n: list(d) for n, d in got}
        if got != want:
            bad.append(key)
    if bad:
        raise ValueError("the program does not run the configuration's "
                         "model: " + ", ".join(bad))


def query_of(traffic: dict, emb: torch.Tensor, j: int) -> torch.Tensor:
    """Query j's embeddings: its positive, then the negatives."""
    pos = traffic["positives"]
    return torch.cat([emb[j % pos][None], emb[pos:]])


class Program:
    """The program's side: its scene, cameras, decoder and model."""

    def __init__(self, ctx, inp: dict):
        from collab_splats_tpu_torch.core.cameras import make_camera
        from collab_splats_tpu_torch.features import decoder as decoder_lib
        from collab_splats_tpu_torch.pipeline.methods import get_method

        cfg = ctx.config
        kwargs = dict(cfg["method_kwargs"])
        kwargs["feature_dims"] = tuple(
            (n, tuple(d)) for n, d in sorted(kwargs["feature_dims"].items()))
        self.model = get_method(cfg["method"]).make_trainer_config(
            **kwargs).model
        check_model(self.model, cfg)
        self.cams = [make_camera(float(r["K"][0, 0]), float(r["K"][1, 1]),
                                 float(r["K"][0, 2]), float(r["K"][1, 2]),
                                 r["width"], r["height"], r["c2w"],
                                 device=ctx.device) for r in inp["rig"]]
        self.decoder = decoder_lib.TwoLayerDecoder(
            self.model.latent_dim, self.model.mlp_hidden_dim,
            self.model.feature_dims_dict(), device=ctx.device)
        with torch.no_grad():
            for k, t in decoder_lib.decoder_tensors(self.decoder).items():
                t.copy_(inp["decoder"][k])
        self.params, self.alive, self.emb = inp["params"], inp["alive"], \
            inp["emb"]
        self.traffic = ctx.traffic
        self.order = np.random.default_rng(
            scene.sub_seed(ctx.seed, 14)).permutation(len(self.cams))

    def view(self, j: int) -> int:
        return int(self.order[j % len(self.order)])

    @torch.no_grad()
    def query(self, j: int) -> np.ndarray:
        """Query j: render view j, score it, read the map to the host."""
        from collab_splats_tpu_torch.models import rade_features

        t = self.traffic
        out, _ = rade_features.get_outputs(
            self.params, self.alive, self.cams[self.view(j)], t["step"],
            self.model, training=False)
        sim = rade_features.similarity_map(
            self.decoder, out, query_of(t, self.emb, j), 1, self.model,
            resize_factor=t["resize_factor"])
        return sim.cpu().numpy()


def reference_maps(ctx, views: List[int], prec: Products,
                   shift: int = 0) -> List[np.ndarray]:
    """The reference's maps of queries 0.. on those views (``shift``
    takes each query's positive that many places on: a fault)."""
    t, model = ctx.traffic, ctx.config["model"]
    inp = make_inputs(ctx.seed, ctx.config, t, ctx.device)
    out = []
    for j, v in enumerate(views):
        cam = R.camera(inp["rig"][v], ctx.device)
        out.append(RQ.similarity_map(
            inp["params"], inp["alive"], cam, t["step"], model,
            inp["decoder"], query_of(t, inp["emb"], j + shift), 1,
            t["resize_factor"], prec).cpu().numpy())
    return out


def numbers(got: List[np.ndarray], ref: List[np.ndarray]
            ) -> Dict[str, float]:
    """The worst checked query's mean and largest |map - reference map|
    (the maps are probabilities in [0, 1])."""
    diffs = [np.abs(g - r) for g, r in zip(got, ref)]
    return {"map_gap": float(max(d.mean() for d in diffs)),
            "map_max_gap": float(max(d.max() for d in diffs))}


def setup(ctx):
    """(the program's side, the checked queries' maps)."""
    inp = make_inputs(ctx.seed, ctx.config, ctx.traffic, ctx.device)
    ctx.sync()
    ctx.mark("inputs")
    prog = Program(ctx, inp)
    del inp
    maps = [prog.query(j) for j in range(ctx.traffic["check_queries"])]
    ctx.sync()
    ctx.mark("checked_queries")
    return prog, maps


def run(ctx) -> dict:
    prog, maps = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    k = len(maps)
    queries, failed = 0, 0
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        m = prog.query(k + queries)
        queries += 1
        failed += int(not np.isfinite(m).all())
        if time.perf_counter() >= end:
            break
    ctx.sync()
    wall = time.perf_counter() - start
    step_ms = window.ms_per_unit(wall, queries)
    out = {"attempted": queries, "failed": failed,
           "e2e": {"setup_s": setup_s, "step_ms": step_ms}}
    if ctx.trace:
        out["layer"] = traced(ctx, prog, k + queries, step_ms / 1e3)
    out["memory_peak_bytes"] = ctx.memory_peak()
    views = [prog.view(j) for j in range(k)]
    del prog
    gc.collect()
    ctx.free()
    out["numbers"] = numbers(maps, reference_maps(ctx, views,
                                                  Products(False)))
    return out


def traced(ctx, prog, done: int, unit_s: float) -> dict:
    """Trace ``trace_queries`` more queries; what the readers read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    try:
        from collab_splats_tpu_torch.utils import profiling
        profiling.reset()
    except (ImportError, AttributeError):
        pass
    k = ctx.traffic["trace_queries"]
    ctx.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for j in range(k):
                prog.query(done + j)
            ctx.sync()
    summary = trace.summarize(trace.from_profiler(prof))
    return {"kind": "query", "units": k, "unit_s": unit_s,
            "summary": summary, "bound_s": {}, "useful_ops": 0.0}

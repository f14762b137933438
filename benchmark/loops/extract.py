"""The extract loop: both feature towers over one frame after another,
``FeatureDatamanager.extract(frame)``, closed loop, one client.

Set-up draws the configuration's weights from the seed on the card (both
towers in the converter's layout, ``reference/vit.py::init_clip`` and
``init_dinov2``), writes them as ``clip_vitl14_336.npz`` and
``dinov2_vits14.npz`` into a directory of the checkout that the program is
pointed at (``COLLAB_SPLATS_WEIGHTS``), draws the traffic's frames and
builds the program's ``FeatureDatamanager`` on them as a user would: its
``get_extractor`` finds the two files (the released towers' branch), and
its set-up extracts every frame once, which warms every shape the window
uses.  The files are deleted once they are loaded.  The window then
extracts the frames in a seeded order for the run's seconds; a unit ends
with both maps on the card in the frame's slot, as ``_setup_features``
keeps them.  Once it has closed, the checked frames' slots are copied to
the host, the program is freed, and the plain reference
(``reference/vit.py``) recomputes those frames' maps from the same seeded
weights.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchlib import scene, trace, window
from counts import vit as vit_counts
from reference import vit as R

ROOT = Path(__file__).resolve().parents[2]
# (the configuration's tower, the program's extractor name)
TOWERS = (("clip", "clip-vit"), ("dinov2", "dinov2"))
# A gap when the two sides' maps differ in shape: past any limit.
NO_GAP = 1.0


def clip_spec(cfg: dict) -> R.ClipSpec:
    c, t = cfg["clip"], cfg["clip"]["text"]
    return R.ClipSpec(c["width"], c["layers"], c["heads"], c["patch_size"],
                      c["grid"], c["embed_dim"], t["width"], t["layers"],
                      t["vocab_size"], t["context_length"])


def dino_spec(cfg: dict) -> R.DinoSpec:
    d = cfg["dinov2"]
    return R.DinoSpec(d["width"], d["layers"], d["heads"], d["patch_size"],
                      d["grid"], d["mlp_width"] // d["width"])


def tower(cfg: dict, kind: str) -> R.Tower:
    t = cfg[kind]
    return R.Tower(t["resolution"], t["patch_size"], t["heads"],
                   tuple(t["mean"]), tuple(t["std"]))


def weights(ctx) -> Dict[str, R.Params]:
    """Both towers' seeded weights on the run's device."""
    cfg = ctx.config
    return {"clip": R.init_clip(clip_spec(cfg),
                                scene.generator(ctx.seed, 21, ctx.device),
                                ctx.device),
            "dinov2": R.init_dinov2(dino_spec(cfg),
                                    scene.generator(ctx.seed, 22,
                                                    ctx.device),
                                    ctx.device)}


def frames(ctx) -> List[np.ndarray]:
    """The traffic's seeded [H, W, 3] uint8 frames, on the host: smooth
    colour fields with uniform per-pixel noise of +-``noise``."""
    t = ctx.traffic
    img = scene.smooth_images(ctx.seed, t["frames"], t["height"],
                              t["width"], ctx.device)
    g = scene.generator(ctx.seed, 23, ctx.device)
    img += t["noise"] * (2.0 * torch.rand(img.shape, generator=g,
                                          device=ctx.device) - 1.0)
    return list((img.clamp_(0.0, 1.0) * 255.0).round().to(torch.uint8)
                .cpu().numpy())


def check_program(cfg: dict, dm) -> None:
    """Raise unless the program's extractors run the released towers'
    branch at the configuration's widths, depths, heads, resolutions and
    normalisations."""
    bad = []
    for kind, name in TOWERS:
        t, ex = cfg[kind], dm._extractors[name]
        p = ex.params
        got = {"pretrained": ex.pretrained, "resolution": ex.resolution,
               "patch_size": ex.patch_size, "heads": ex.num_heads,
               "mean": list(ex.mean), "std": list(ex.std)}
        want = {"pretrained": True, "resolution": t["resolution"],
                "patch_size": t["patch_size"], "heads": t["heads"],
                "mean": t["mean"], "std": t["std"]}
        if kind == "clip":
            got.update(feature_dim=ex.feature_dim,
                       width=int(p["visual.ln_pre.scale"].shape[0]),
                       layers=int(p["visual.n_blocks"]),
                       text_heads=ex.text_heads)
            want.update(feature_dim=t["embed_dim"], width=t["width"],
                        layers=t["layers"], text_heads=t["text"]["heads"])
        else:
            got.update(feature_dim=ex.feature_dim,
                       layers=int(p["n_blocks"]))
            want.update(feature_dim=t["width"], layers=t["layers"])
        bad += [f"{name}.{k}: {got[k]!r} != {want[k]!r}" for k in want
                if got[k] != want[k]]
    if bad:
        raise ValueError("the program does not run the configuration's "
                         "towers: " + "; ".join(bad))


def _clear_extractors() -> None:
    """Forget the program's extractor instances: ``get_extractor`` keeps
    one per (name, device) for the process, so a second build in one
    process (the calibration's seeds) would reuse the first's weights,
    and freeing the program needs them gone."""
    from collab_splats_tpu_torch.features import extractors

    extractors._default_extractor.cache_clear()


def build(ctx, fs: List[np.ndarray]):
    """The program's ``FeatureDatamanager`` over the frames, its towers
    read from the seeded weights' files."""
    from collab_splats_tpu_torch.data.datamanager import \
        FullImageDatamanager
    from collab_splats_tpu_torch.features import datamanager as DM

    if not hasattr(DM.FeatureDatamanager, "extract"):
        raise RuntimeError("the program's FeatureDatamanager has no "
                           "extract(image): it cannot run this cell")
    cfg = ctx.config
    wdir = ROOT / "build" / "bench_cache" / f"vit-{os.getpid()}"
    wdir.mkdir(parents=True, exist_ok=True)
    try:
        p = weights(ctx)
        for kind, _ in TOWERS:
            np.savez(wdir / cfg[kind]["weights_file"],
                     **{k: v.cpu().numpy() for k, v in p[kind].items()})
        del p
        ctx.free()
        os.environ["COLLAB_SPLATS_WEIGHTS"] = str(wdir) + (
            os.pathsep + os.environ["COLLAB_SPLATS_WEIGHTS"]
            if os.environ.get("COLLAB_SPLATS_WEIGHTS") else "")
        _clear_extractors()
        d = cfg["datamanager"]
        base = FullImageDatamanager([None] * len(fs), [], fs, [])
        dm = DM.FeatureDatamanager(base, DM.FeatureDatamanagerConfig(
            feature_type=d["feature_type"], extractors=tuple(d["extractors"]),
            final_resolution=d["final_resolution"]), device=ctx.device)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    check_program(cfg, dm)
    return dm


def setup(ctx):
    """(the program's datamanager, the frames)."""
    fs = frames(ctx)
    ctx.mark("frames")
    dm = build(ctx, fs)
    ctx.sync()
    ctx.mark("program")
    return dm, fs


def slots(dm, k: int) -> List[Dict[str, torch.Tensor]]:
    """The first ``k`` frames' maps as the program keeps them, on the
    host."""
    return [{name: m.cpu() for name, m in dm.train_features[i].items()}
            for i in range(k)]


def free(ctx) -> None:
    """Free what the program held, once the caller has dropped it."""
    _clear_extractors()
    gc.collect()
    ctx.free()


def reference_maps(ctx, p: Dict[str, R.Params], fs: List[np.ndarray],
                   prec: R.Precision, fault: Optional[str] = None
                   ) -> List[Dict[str, torch.Tensor]]:
    """The reference's final maps of the frames under the program's
    extractor names (``fault``: ``reference/vit.py::tower_map``'s)."""
    cfg = ctx.config
    out = []
    for f in fs:
        frame = torch.as_tensor(f, device=ctx.device)
        out.append({name: R.tower_map(
            kind, p[kind], frame, tower(cfg, kind),
            cfg["datamanager"]["final_resolution"], prec, fault).cpu()
            for kind, name in TOWERS})
    return out


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    if got.shape != ref.shape:
        return NO_GAP
    return float((got - ref).abs().max() / ref.abs().max())


def compare(got: List[dict], ref: List[dict]) -> Dict[str, float]:
    """The check's three numbers over the checked frames: each tower's
    largest |program - reference| over the reference's largest |value|
    on its final map (the worst frame's), and 1 where any map's shape is
    not the reference's, else 0."""
    out = {"clip_gap": 0.0, "dino_gap": 0.0, "shape_mismatch": 0.0}
    for g, r in zip(got, ref):
        for key, name in (("clip_gap", "clip-vit"), ("dino_gap", "dinov2")):
            out[key] = max(out[key], _gap(g[name], r[name]))
            if g[name].shape != r[name].shape:
                out["shape_mismatch"] = 1.0
    return out


def _nonfinite(fmap: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([~torch.isfinite(m).all() for m in fmap.values()]
                       ).any()


def run(ctx) -> dict:
    dm, fs = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    order = np.random.default_rng(scene.sub_seed(ctx.seed, 24)).permutation(
        len(fs))
    bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
    images = 0
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        i = int(order[images % len(fs)])
        fmap = dm.extract(fs[i])
        dm.train_features[i] = fmap
        bad += _nonfinite(fmap)
        images += 1
        if time.perf_counter() >= end:
            break
    ctx.sync()
    wall = time.perf_counter() - start
    step_ms = window.ms_per_unit(wall, images)
    out = {"attempted": images, "failed": int(bad),
           "e2e": {"setup_s": setup_s, "step_ms": step_ms}}
    if ctx.trace:
        out["layer"] = traced(ctx, dm, fs, order, images, step_ms / 1e3)
    out["memory_peak_bytes"] = ctx.memory_peak()
    k = ctx.traffic["check_images"]
    got = slots(dm, k)
    del dm
    free(ctx)
    ref = reference_maps(ctx, weights(ctx), fs[:k], R.Precision())
    out["numbers"] = compare(got, ref)
    return out


def traced(ctx, dm, fs, order, done: int, unit_s: float) -> dict:
    """Trace ``trace_images`` more frames; what the per-layer readers
    read."""
    from collab_splats_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile, record_function

    k = ctx.traffic["trace_images"]
    ctx.sync()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for j in range(k):
                i = int(order[(done + j) % len(fs)])
                dm.train_features[i] = dm.extract(fs[i])
            ctx.sync()
    summary = trace.summarize(trace.from_profiler(prof))
    t = profiling.totals()
    units = t["spans"].get("features.image", {}).get("count", 0)
    if units:
        tokens = t["counters"].get("vit.tokens", 0.0) / units
        print(f"vit.tokens per image {tokens}", file=sys.stderr)
    h, w = ctx.traffic["height"], ctx.traffic["width"]
    return {"kind": "extract", "units": k, "unit_s": unit_s,
            "summary": summary, "bound_s": {},
            "useful_ops": k * vit_counts.image(ctx.config, h, w)}

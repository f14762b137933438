"""The segment loop: SAM's automatic masks of one frame after another,
``Segmentation(sam_model=..., auto_mask=...).auto_segment_image(frame)``,
closed loop, one client.

Set-up draws the configuration's weights from the seed on the card (the
encoder as drawn, the decoder rebuilt by ``benchlib/sam_weights.py`` so
that each prompt's masks are localised and about one in twenty passes the
filter), writes them as ``sam_<model>.npz`` in the converter's layout into
a directory of the checkout that the program is pointed at
(``COLLAB_SPLATS_WEIGHTS``), builds the program's ``Segmentation`` from it
(the file is deleted once it is loaded), draws the traffic's frames, and
segments the first
``check_images`` frames, keeping what the check needs: the embedding, each
prompt batch's low-resolution logits and predicted IoUs, and the kept
masks.  The window then segments the frames in a seeded order for the
run's seconds; a unit ends with the result dicts on the host.  Once it has
closed, the program is freed and the plain reference (``reference/sam.py``)
segments the checked frames from the same seeded weights.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchlib import sam_weights, scene, trace, window
from counts import sam as sam_counts
from reference import sam as R

ROOT = Path(__file__).resolve().parents[2]
# A kept mask and one of the other side's are partners when their IoU
# reaches this: a mask that one side keeps and the other suppresses (an
# NMS decision at rounding's distance from the threshold) overlaps a mask
# the other side keeps by more than the NMS threshold.
SAME_MASK = 0.5


def spec(cfg: dict) -> R.Spec:
    e = cfg["image_encoder"]
    return R.Spec(e["embed_dim"], e["depth"], e["num_heads"],
                  tuple(e["global_attn_indexes"]), e["window_size"])


def weights(ctx) -> R.Params:
    """The configuration's seeded weights on the run's device."""
    p = R.init_params(spec(ctx.config), scene.generator(ctx.seed, 11,
                                                        ctx.device),
                      ctx.device)
    sam_weights.localise(p, scene.generator(ctx.seed, 13, ctx.device))
    return p


def frames(ctx) -> List[np.ndarray]:
    """The traffic's seeded [H, W, 3] uint8 frames, on the host."""
    t = ctx.traffic
    img = scene.smooth_images(ctx.seed, t["frames"], t["height"],
                              t["width"], ctx.device)
    return list((img * 255.0).round().to(torch.uint8).cpu().numpy())


def check_program(cfg: dict, sam_predictor) -> None:
    """Raise unless the program's table of SAM's encoders holds the
    configuration's widths under its model name."""
    want = sam_predictor.EncoderSpec(*spec(cfg))
    got = sam_predictor.SAM_ENCODERS.get(cfg["model"])
    if got != want:
        raise ValueError(f"the program's {cfg['model']} is {got}, the "
                         f"configuration's {want}")
    e, d = cfg["image_encoder"], cfg["mask_decoder"]
    fixed = (e["img_size"], e["patch_size"], e["mlp_ratio"], e["out_chans"],
             d["transformer_dim"], d["depth"], d["num_heads"], d["mlp_dim"],
             d["attention_downsample_rate"], d["num_multimask_outputs"])
    if fixed != (1024, 16, 4, 256, 256, 2, 8, 2048, 2, 3):
        raise ValueError(f"the program's SAM is fixed at another input, "
                         f"neck or decoder: {fixed}")


def auto_mask(cfg: dict, sam_predictor):
    a = {k: v for k, v in cfg["auto_mask"].items()
         if k != "multimask_output"}
    if not cfg["auto_mask"]["multimask_output"]:
        raise ValueError("the automatic masks run multimask")
    return sam_predictor.AutoMaskConfig(**a)


def build(ctx):
    """The program's ``Segmentation`` on the configuration's weights."""
    from collab_splats_tpu_torch.features import sam_predictor
    from collab_splats_tpu_torch.features.segmentation import Segmentation

    cfg = ctx.config
    check_program(cfg, sam_predictor)
    settings = auto_mask(cfg, sam_predictor)
    wdir = ROOT / "build" / "bench_cache" / f"sam-{os.getpid()}"
    wdir.mkdir(parents=True, exist_ok=True)
    try:
        p = weights(ctx)
        np.savez(wdir / f"sam_{cfg['model']}.npz",
                 **{k: v.cpu().numpy() for k, v in p.items()})
        del p
        ctx.free()
        os.environ["COLLAB_SPLATS_WEIGHTS"] = str(wdir) + (
            os.pathsep + os.environ["COLLAB_SPLATS_WEIGHTS"]
            if os.environ.get("COLLAB_SPLATS_WEIGHTS") else "")
        seg = Segmentation(device=ctx.device, sam_model=cfg["model"],
                           auto_mask=settings)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    if seg.sam is None or seg.sam.model != cfg["model"]:
        raise RuntimeError("the program did not build SAM "
                           f"{cfg['model']} from the weights")
    return seg, settings


def grid(settings, h: int, w: int) -> np.ndarray:
    n = settings.points_per_side
    g = (np.arange(n) + 0.5) / n
    return np.stack(np.meshgrid(g * w, g * h), axis=-1).reshape(-1, 2)


def checked_image(seg, settings, frame: np.ndarray) -> dict:
    """One frame through the timed call, then its embedding and each
    prompt batch's logits and IoUs through the same backend: the
    readings the check compares."""
    kept = seg.auto_segment_image(frame)
    sam = seg.sam
    pts = grid(settings, *frame.shape[:2])
    prompt_of = {tuple(xy): i for i, xy in enumerate(pts.tolist())}
    lows, ious = [], []
    for s0 in range(0, len(pts), settings.points_per_batch):
        low, iou = sam.predict_points_low(pts[s0:s0 + settings.
                                              points_per_batch])
        lows.append(torch.from_numpy(low))
        ious.append(torch.from_numpy(iou))
    return {"embedding": sam._embedding.cpu(), "low": lows, "iou": ious,
            "kept": [(prompt_of[tuple(r["point_coords"][0])],
                      torch.from_numpy(r["segmentation"])) for r in kept]}


def readings(img: R.Image) -> dict:
    """A reference run's readings in the form of the program's."""
    return {"embedding": img.embedding.cpu(),
            "low": [x.cpu() for x in img.low],
            "iou": [x.cpu() for x in img.iou],
            "kept": [(r["prompt"], r["segmentation"].cpu())
                     for r in img.kept]}


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def kept_mismatch(mine: list, theirs: list) -> float:
    """The share of kept masks, both sides' together, that find no
    partner: a kept mask of the other side whose IoU with it reaches
    ``SAME_MASK``.  Each side is (prompt, mask) pairs."""
    if not mine and not theirs:
        return 0.0

    def partnered(a, others):
        for _, m in others:
            inter = float((a & m).sum())
            union = float((a | m).sum())
            if union and inter / union >= SAME_MASK:
                return True
        return False

    lone = sum(not partnered(a, theirs) for _, a in mine) + \
        sum(not partnered(b, mine) for _, b in theirs)
    return lone / (len(mine) + len(theirs))


def compare(got: List[dict], ref: List[R.Image]) -> Dict[str, float]:
    """The check's four numbers, each the worst checked frame's: the
    embedding's and the logits' largest gap over the reference's largest
    value, the predicted IoUs' largest gap, and the share of kept masks
    without a partner (:func:`kept_mismatch`)."""
    out = {"embed_gap": 0.0, "logit_gap": 0.0, "iou_gap": 0.0,
           "kept_mismatch": 0.0}
    for g, r in zip(got, ref):
        out["embed_gap"] = max(out["embed_gap"],
                               _gap(g["embedding"], r.embedding))
        for gl, gi, rl, ri in zip(g["low"], g["iou"], r.low, r.iou):
            out["logit_gap"] = max(out["logit_gap"], _gap(gl, rl))
            out["iou_gap"] = max(out["iou_gap"],
                                 float((gi - ri.cpu()).abs().max()))
        out["kept_mismatch"] = max(out["kept_mismatch"], kept_mismatch(
            g["kept"], [(k["prompt"], k["segmentation"].cpu())
                        for k in r.kept]))
    return out


def reference_images(ctx, fs: List[np.ndarray], prec: R.Precision,
                     windowed=(), grid_offset: float = 0.5
                     ) -> List[R.Image]:
    """The reference's automatic masks of the checked frames, from the
    same seeded weights (``windowed``, ``grid_offset``: the faults of
    running those global blocks in windows and of moving the grid,
    ``reference/sam.py::automatic_masks``)."""
    p = weights(ctx)
    return [R.automatic_masks(
        p, torch.as_tensor(f, device=ctx.device).to(torch.float32),
        ctx.config["auto_mask"], prec, windowed, grid_offset) for f in fs]


def setup(ctx):
    """(the program's Segmentation, its settings, the frames, the checked
    frames' readings)."""
    seg, settings = build(ctx)
    ctx.sync()
    ctx.mark("program")
    fs = frames(ctx)
    ctx.mark("frames")
    checked = [checked_image(seg, settings, fs[i])
               for i in range(ctx.traffic["check_images"])]
    ctx.sync()
    ctx.mark("checked_images")
    return seg, settings, fs, checked


def run(ctx) -> dict:
    seg, settings, fs, checked = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    order = np.random.default_rng(scene.sub_seed(ctx.seed, 12)).permutation(
        len(fs))
    images, failed = 0, 0
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        kept = seg.auto_segment_image(fs[order[images % len(fs)]])
        images += 1
        failed += int(not all(np.isfinite(r["predicted_iou"]) for r in kept))
        if time.perf_counter() >= end:
            break
    ctx.sync()
    wall = time.perf_counter() - start
    step_ms = window.ms_per_unit(wall, images)
    out = {"attempted": images, "failed": failed,
           "e2e": {"setup_s": setup_s, "step_ms": step_ms}}
    if ctx.trace:
        out["layer"] = traced(ctx, seg, fs, order, images, step_ms / 1e3)
    out["memory_peak_bytes"] = ctx.memory_peak()
    del seg
    gc.collect()
    ctx.free()
    ref = reference_images(ctx, fs[:ctx.traffic["check_images"]],
                           R.Precision())
    out["numbers"] = compare(checked, ref)
    print("kept per checked frame (program, reference): " + ", ".join(
        f"{len(g['kept'])} {len(r.kept)}" for g, r in zip(checked, ref)),
        file=sys.stderr)
    return out


def traced(ctx, seg, fs, order, done: int, unit_s: float) -> dict:
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
                seg.auto_segment_image(fs[order[(done + j) % len(fs)]])
            ctx.sync()
    summary = trace.summarize(trace.from_profiler(prof))
    return {"kind": "segment", "units": k, "unit_s": unit_s,
            "summary": summary, "bound_s": {},
            "useful_ops": k * sam_counts.image(ctx.config)}


"""The box-segmentation loop: MobileSAMv2's object-aware masks of one
frame after another, ``Segmentation(sam_model=..., yolo_model=...)
.auto_segment_image(frame)``, closed loop, one client.

Set-up draws the configuration's weights from the seed on the card: SAM
as the segment loop draws it, its decoder rebuilt by
``benchlib/box_weights.py`` so that box masks localise, and YOLOv8 by
``reference/yolo.py::init_params`` (folded over the traffic's first
``fold_images`` letterboxed frames), the class branch's final bias then
shifted so that the median over the traffic's frames of the boxes kept
after NMS reaches ``target_kept`` and the least ``floor_kept``
(:func:`calibrate`).  It writes both as
``sam_<model>.npz`` and ``yolov8_objaware.npz`` in the converters' layouts
into a directory of the checkout that the program is pointed at
(``COLLAB_SPLATS_WEIGHTS``), builds the program's ``Segmentation`` from
them (the files are deleted once loaded), and segments the first
``check_images`` frames, keeping what the check needs: the embedding, the
detector's raw boxes and scores and its kept boxes, the low-resolution
logits of those boxes, and the returned masks.  The facade picks the
object path by itself.  The window then segments the frames in a seeded
order for the run's seconds; a unit ends with the result dicts on the
host.  Once it has closed, the program is freed and the plain references
(``reference/yolo.py``, ``reference/boxseg.py``) segment the checked
frames from the same seeded weights.
"""

from __future__ import annotations

import gc
import inspect
import math
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchlib import box_weights, scene, trace, window
from counts import yolo as yolo_counts
from loops import segment
from reference import boxseg as RB
from reference import sam as R
from reference import yolo as Y
from reference.precision import Products

ROOT = Path(__file__).resolve().parents[2]
# A kept box and one of the other side's are partners when their IoU
# reaches this: an NMS decision that flips at rounding's distance from
# its threshold keeps a box that overlaps the other side's by more than
# the NMS IoU, and a box that both keep moves by rounding only.
SAME_BOX = 0.9


def sam_weights(ctx) -> R.Params:
    """SAM's seeded weights on the run's device, the decoder localised
    for box prompts."""
    p = R.init_params(segment.spec(ctx.config),
                      scene.generator(ctx.seed, 11, ctx.device), ctx.device)
    box_weights.localise_boxes(p, scene.generator(ctx.seed, 13, ctx.device))
    return p


def yolo_weights(ctx):
    """(YOLOv8's seeded weights on the run's device, the detector's class
    bias calibrated; each frame's kept count at the calibration)."""
    fs = frame_tensors(ctx)
    det = ctx.config["detector"]
    ys = Y.spec(det)
    boxed = [Y.letterbox(f, det["imgsz"], det["pad_multiple"],
                         det["pad_value"])[0] for f in fs]
    yp = Y.init_params(ys, scene.generator(ctx.seed, 21, ctx.device),
                       ctx.device,
                       torch.stack(boxed[:ctx.traffic["fold_images"]]))
    shift, kept = calibrate(yp, ys, boxed, det, ctx.traffic["target_kept"],
                            ctx.traffic["floor_kept"])
    for lvl in range(len(ys.strides)):
        yp[f"22.cv3.{lvl}.2.b"] += shift
    return yp, kept


def frame_tensors(ctx) -> torch.Tensor:
    """The traffic's seeded [N, H, W, 3] frames, pixels 0..255 as whole
    numbers in float32, on the device."""
    t = ctx.traffic
    img = scene.smooth_images(ctx.seed, t["frames"], t["height"],
                              t["width"], ctx.device)
    return (img * 255.0).round()


def frames(ctx) -> List[np.ndarray]:
    """The traffic's seeded [H, W, 3] uint8 frames, on the host."""
    return list(frame_tensors(ctx).to(torch.uint8).cpu().numpy())


def _kept_count(boxes: np.ndarray, scores: np.ndarray, iou: float,
                max_det: int) -> int:
    """How many boxes class-agnostic greedy NMS keeps (in numpy: the
    bisection runs it some 900 times, ``reference/yolo.py::nms`` on the
    host's tensors takes several times as long)."""
    order = np.argsort(-scores, kind="stable")
    x1, y1, x2, y2 = boxes.T
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    n = 0
    while order.size and n < max_det:
        i, rest = order[0], order[1:]
        n += 1
        inter = np.maximum(np.minimum(x2[i], x2[rest])
                           - np.maximum(x1[i], x1[rest]), 0) * \
            np.maximum(np.minimum(y2[i], y2[rest])
                       - np.maximum(y1[i], y1[rest]), 0)
        order = rest[inter / np.maximum(area[i] + area[rest] - inter, 1e-9)
                     <= iou]
    return n


def calibrate(yp, ys: Y.Spec, boxed: List[torch.Tensor], det: dict,
              target: int, floor: int, steps: int = 14):
    """(the least shift of every class logit at which the median over the
    letterboxed frames ``boxed`` of the boxes NMS keeps reaches
    ``target`` and their least reaches ``floor``, each found by bisection
    on the reference's raw outputs; each frame's kept count at it)."""
    prec = Products(False)
    raw = []
    with torch.no_grad():
        for img in boxed:
            b, lg = Y.forward(yp, ys, img, prec)
            raw.append((b.cpu().numpy().astype(np.float64),
                        lg.amax(dim=1).cpu().numpy().astype(np.float64)))
    cut = math.log(det["conf"] / (1.0 - det["conf"]))

    def counts(shift):
        out = []
        for b, lg in raw:
            sel = lg + shift >= cut
            out.append(_kept_count(b[sel], lg[sel], det["iou"],
                                   det["max_det"]))
        return out

    def bisect(stat, want):
        lo, hi = -16.0, 16.0
        for _ in range(steps):
            mid = 0.5 * (lo + hi)
            if stat(counts(mid)) < want:
                lo = mid
            else:
                hi = mid
        return hi

    shift = max(bisect(np.median, target), bisect(min, floor))
    return shift, counts(shift)


def check_program(cfg: dict, sam_predictor, yolo) -> None:
    """Raise unless the program's tables of SAM's encoders and YOLOv8's
    scales hold the configuration's widths under their names, and its
    detector and box prompts run the configuration's settings."""
    segment.check_program(cfg, sam_predictor)
    det = cfg["detector"]
    scale = (det["depth_multiple"], det["width_multiple"],
             det["max_channels"])
    got = yolo.YOLO_SCALES.get(cfg["detector_model"])
    if got != scale:
        raise ValueError(f"the program's YOLOv8{cfg['detector_model']} is "
                         f"{got}, the configuration's {scale}")
    want = Y.shapes(Y.spec(det))
    if yolo.scale_shapes(cfg["detector_model"], det["nc"],
                         det["reg_max"]) != want:
        raise ValueError("the program's YOLOv8 layers are not the "
                         "configuration's widths and repeats")
    fixed = (yolo.IMG_SIZE, tuple(yolo.STRIDES), yolo.REG_MAX)
    if fixed != (det["imgsz"], tuple(det["strides"]), det["reg_max"]):
        raise ValueError(f"the program's detector is fixed at {fixed}")
    batch = inspect.signature(sam_predictor.SamBackend.segment_boxes
                              ).parameters["batch_size"].default
    if batch != cfg["box_prompts"]["batch"] or \
            cfg["box_prompts"]["multimask_output"]:
        raise ValueError(f"the program decodes boxes {batch} at a time, "
                         "one mask each")


def build(ctx):
    """(the program's ``Segmentation`` on the configuration's weights,
    the calibration's kept count per frame).  The detector's weights stay
    on the host for the reference (their fold and calibration read the
    card's arithmetic)."""
    from collab_splats_tpu_torch.features import sam_predictor, yolo
    from collab_splats_tpu_torch.features.segmentation import Segmentation

    cfg = ctx.config
    det = cfg["detector"]
    check_program(cfg, sam_predictor, yolo)
    wdir = ROOT / "build" / "bench_cache" / f"boxseg-{os.getpid()}"
    wdir.mkdir(parents=True, exist_ok=True)
    try:
        yp, kept = yolo_weights(ctx)
        ctx.yolo_params = {k: v.cpu() for k, v in yp.items()}
        del yp
        np.savez(wdir / "yolov8_objaware.npz",
                 **{k: v.numpy() for k, v in ctx.yolo_params.items()})
        p = sam_weights(ctx)
        np.savez(wdir / f"sam_{cfg['model']}.npz",
                 **{k: v.cpu().numpy() for k, v in p.items()})
        del p
        ctx.free()
        os.environ["COLLAB_SPLATS_WEIGHTS"] = str(wdir) + (
            os.pathsep + os.environ["COLLAB_SPLATS_WEIGHTS"]
            if os.environ.get("COLLAB_SPLATS_WEIGHTS") else "")
        seg = Segmentation(device=ctx.device, sam_model=cfg["model"],
                           yolo_model=cfg["detector_model"])
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    d = seg.detector
    if seg.sam is None or seg.sam.model != cfg["model"] or d is None or \
            d.model != cfg["detector_model"]:
        raise RuntimeError("the program did not build SAM "
                           f"{cfg['model']} and YOLOv8"
                           f"{cfg['detector_model']} from the weights")
    if (d.conf, d.iou, d.max_det) != (det["conf"], det["iou"],
                                      det["max_det"]):
        raise ValueError(f"the program's detector runs conf {d.conf}, IoU "
                         f"{d.iou}, max_det {d.max_det}")
    return seg, kept


def checked_image(seg, frame: np.ndarray) -> dict:
    """One frame through the timed call, then the readings the check
    compares, through the same detector and backend."""
    from collab_splats_tpu_torch.features.yolo import yolo_forward

    kept = seg.auto_segment_image(frame)
    emb = seg.sam._embedding.cpu()
    det = seg.detector
    with torch.no_grad():
        raw_boxes, raw_scores = yolo_forward(det.params,
                                             det.letterbox(frame)[0])
    boxes, _ = det(frame)
    lows = [torch.from_numpy(seg.sam.predict_boxes_low(boxes[s0:s0 + 64])[0])
            for s0 in range(0, len(boxes), 64)]
    return {"embedding": emb, "raw_boxes": raw_boxes.cpu(),
            "raw_scores": raw_scores.amax(dim=1).cpu(),
            "boxes": torch.from_numpy(boxes),
            "low": torch.cat(lows) if lows else torch.zeros((0, 256, 256)),
            "kept": [(j, torch.from_numpy(r["segmentation"]))
                     for j, r in enumerate(kept)]}


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``segment._gap``; readings of other shapes (another number of
    boxes) are infinitely far apart, and two empty ones not at all."""
    if got.shape != ref.shape:
        return math.inf
    return segment._gap(got, ref) if len(ref) else 0.0


def _box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    lo = torch.maximum(a[:, None, :2], b[None, :, :2])
    hi = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(dim=2)

    def area(x):
        return (x[:, 2:] - x[:, :2]).clamp(min=0).prod(dim=1)

    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / union.clamp(min=1e-9)


def box_mismatch(mine: torch.Tensor, theirs: torch.Tensor) -> float:
    """The share of kept boxes, both sides' together, without a partner:
    a box of the other side whose IoU with it reaches ``SAME_BOX``."""
    n = len(mine) + len(theirs)
    if not len(mine) or not len(theirs):
        return 0.0 if not n else 1.0
    ok = _box_iou(mine, theirs.cpu()) >= SAME_BOX
    return float((~ok.any(dim=1)).sum() + (~ok.any(dim=0)).sum()) / n


def reference_images(ctx, fs: List[np.ndarray], got: List[dict],
                     tf32: bool = False, centre: float = 0.5,
                     corners=(2, 3)) -> List[dict]:
    """The references' readings of the checked frames from the same
    seeded weights: the embedding, the detector's raw outputs and kept
    boxes, the logits of the program's kept boxes (``got``), and the
    masks of the reference's own boxes.  ``tf32``, ``centre`` and
    ``corners`` are the faults the check has to catch
    (``reference/yolo.py::forward``, ``reference/boxseg.py``)."""
    p = sam_weights(ctx)
    yp = {k: v.to(ctx.device) for k, v in ctx.yolo_params.items()}
    ys, det = Y.spec(ctx.config["detector"]), ctx.config["detector"]
    sam_prec, yolo_prec = R.Precision(tf32), Products(tf32)
    out = []
    for f, g in zip(fs, got):
        img = torch.as_tensor(f, device=ctx.device).to(torch.float32)
        d = Y.detect(yp, ys, img, det, yolo_prec, centre)
        emb = R.encode(p, R.preprocess(img), sam_prec)
        scale = R.IMG / max(img.shape[:2])
        low, _ = RB.low_logits(p, emb, g["boxes"].to(ctx.device), scale,
                               sam_prec, corners)
        mine = RB.segment_boxes(p, img, d.kept, sam_prec, emb, corners)
        out.append({"embedding": emb.cpu(), "raw_boxes": d.boxes.cpu(),
                    "raw_scores": d.scores.cpu(), "boxes": d.kept.cpu(),
                    "low": low.cpu(),
                    "kept": [(k["box"], k["segmentation"].cpu())
                             for k in mine.kept]})
    return out


def compare(got: List[dict], ref: List[dict]) -> Dict[str, float]:
    """The check's five numbers, each the worst checked frame's: the
    embedding's, the detector's raw boxes' and scores' and the box
    logits' largest gap over the reference's largest value, and the
    shares of kept boxes (:func:`box_mismatch`) and of returned masks
    (``segment.kept_mismatch``) without a partner."""
    out = {"embed_gap": 0.0, "det_gap": 0.0, "box_mismatch": 0.0,
           "logit_gap": 0.0, "mask_mismatch": 0.0}
    for g, r in zip(got, ref):
        out["embed_gap"] = max(out["embed_gap"],
                               _gap(g["embedding"], r["embedding"]))
        out["det_gap"] = max(out["det_gap"],
                             _gap(g["raw_boxes"], r["raw_boxes"]),
                             _gap(g["raw_scores"], r["raw_scores"]))
        out["box_mismatch"] = max(out["box_mismatch"],
                                  box_mismatch(g["boxes"], r["boxes"]))
        out["logit_gap"] = max(out["logit_gap"], _gap(g["low"], r["low"]))
        out["mask_mismatch"] = max(out["mask_mismatch"],
                                   segment.kept_mismatch(g["kept"],
                                                         r["kept"]))
    return out


def setup(ctx):
    """(the program's Segmentation, the frames, the checked frames'
    readings)."""
    seg, kept = build(ctx)
    ctx.sync()
    ctx.mark("program")
    print("boxes kept per frame at set-up (reference's NMS): "
          + " ".join(str(k) for k in kept), file=sys.stderr)
    fs = frames(ctx)
    ctx.mark("frames")
    checked = [checked_image(seg, fs[i])
               for i in range(ctx.traffic["check_images"])]
    ctx.sync()
    ctx.mark("checked_images")
    return seg, fs, checked


def run(ctx) -> dict:
    seg, fs, checked = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    order = np.random.default_rng(scene.sub_seed(ctx.seed, 12)).permutation(
        len(fs))
    images, failed = 0, 0
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        kept = seg.auto_segment_image(fs[order[images % len(fs)]])
        images += 1
        failed += int(not kept or not all(np.isfinite(r["predicted_iou"])
                                          for r in kept))
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
    k = ctx.traffic["check_images"]
    ref = reference_images(ctx, fs[:k], checked)
    out["numbers"] = compare(checked, ref)
    print("boxes and masks per checked frame (program, reference): "
          + ", ".join(f"{len(g['boxes'])} {len(r['boxes'])} "
                      f"{len(g['kept'])} {len(r['kept'])}"
                      for g, r in zip(checked, ref)), file=sys.stderr)
    return out


def traced(ctx, seg, fs, order, done: int, unit_s: float) -> dict:
    """Trace ``trace_images`` more frames; what the per-layer readers
    read."""
    from collab_splats_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile, record_function

    k = ctx.traffic["trace_images"]
    picked = [fs[order[(done + j) % len(fs)]] for j in range(k)]
    ctx.sync()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for f in picked:
                seg.auto_segment_image(f)
            ctx.sync()
    summary = trace.summarize(trace.from_profiler(prof))
    h, w = picked[0].shape[:2]
    ops = sum(yolo_counts.frame(ctx.config, h, w, len(seg.detector(f)[0]))
              for f in picked)
    return {"kind": "boxseg", "units": k, "unit_s": unit_s,
            "summary": summary, "bound_s": {}, "useful_ops": ops}

"""At-scale training run: the full schedule of the reference on one card.

Counterpart of the JAX package's ``scripts/scale_train.py``.  The full
Splatfacto densification schedule, progressive resolution (factor 4 -> 2
-> 1), warmup, dup/split/cull refinement with capacity growth that keeps
the Adam moments, opacity resets, the depth-normal phase from
``--reg-from`` (the reference's ``regularization_from_iter`` = 15000), and
the spill counter.

Two ground-truth modes:

* default: a procedural scene of Gaussian clusters rendered by the model
  itself (drawn from a seeded ``torch.Generator``): exactly representable,
  so it isolates the trainer;
* ``--analytic-gt``: the ray-traced scene of ``data/analytic.py`` (hard
  texture edges, hard shadows, Blinn-Phong speculars), which Gaussians
  cannot represent exactly, seeded from unprojected surface pixels with
  their colours (the COLMAP-points initialization of the pipeline).

``--sh-degree 3`` trains the full spherical-harmonics stack with the
reference's degree schedule (one degree per 1000 steps).  ``--features``
trains rade-features: 13 latents fused into the rasterization, cosine
distillation against the clip-vit and dinov2 extractors' maps of the
ground-truth frames (their seeded offline towers when no weights file is
found), the decoder included.

Writes:
    <out>/history.jsonl            per-step metrics (one row a step)
    <out>/summary.json             final PSNR/SSIM, peak N, it/s, spill
    <out>/step-XXXXXXXX.ckpt.npz   resumable checkpoints every --save-every
Usage:
    python -m collab_splats_tpu_torch.scripts.scale_train [--steps 30000]
        [--out runs/scale] [--analytic-gt] [--sh-degree 3] [--features]
        [--exact-binning] [--resume runs/scale] [--cpu]

``--resume`` takes a checkpoint or a run directory (its latest
checkpoint); history rows past the checkpoint's step move to
``history_prekill.jsonl`` and the run continues bit for bit.  Without
``--cpu`` the run needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.options import RenderOptions
from ..core.sh import num_sh_bases, rgb_to_sh0
from ..data import analytic
from ..data.synthetic import orbit_cameras
from ..features.datamanager import _resize_chw
from ..features.extractors import get_extractor
from ..models import rade_features, rade_gs
from ..models.gaussians import pad_to_capacity
from ..train import optim, strategy
from ..train.checkpoint import latest_checkpoint
from ..train.trainer import Trainer, TrainerConfig
from ..utils.device import resolve_device

N_CAMS = 64                       # the orbit of ground-truth views
FINAL_EVAL_STRIDE = 8             # the summary's eval cameras: every 8th
EXTRACTORS = ("clip-vit", "dinov2")
FEATURE_MAX_EDGE = 64
# The full Splatfacto schedule; a module constant so that a test can
# shorten the warmup of a tiny run.
SCHEDULE = strategy.StrategyConfig()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m collab_splats_tpu_torch.scripts.scale_train",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16500)
    ap.add_argument("--out", type=Path, default=Path("runs/scale_r3"))
    ap.add_argument("--analytic-gt", action="store_true",
                    help="ray-traced (non-Gaussian-representable) ground "
                         "truth instead of self-rendered Gaussian GT")
    ap.add_argument("--scene-spheres", type=int, default=10,
                    help="number of textured spheres in the analytic scene")
    ap.add_argument("--sh-degree", type=int, default=0,
                    help="spherical-harmonics degree (reference trains 3)")
    ap.add_argument("--features", action="store_true",
                    help="train the rade-features head: 13-dim latents, "
                         "cosine distillation + decoder")
    ap.add_argument("--eval-cams", type=int, default=8,
                    help="cameras per eval point (multi-camera mean)")
    ap.add_argument("--exact-binning", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--seed-points", type=int, default=5000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--num-downscales", type=int, default=2)
    ap.add_argument("--res-schedule", type=int, default=3000)
    ap.add_argument("--reg-from", type=int, default=15000,
                    help="depth-normal regularization start iteration")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--capacity", type=int, default=32768,
                    help="initial Gaussian capacity")
    ap.add_argument("--save-every", type=int, default=2000,
                    help="checkpoint cadence (0 disables)")
    ap.add_argument("--resume", type=Path, default=None,
                    help="checkpoint to resume from: a step-*.ckpt.npz "
                         "file, or a run directory (picks the latest)")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


# ------------------------------------------------------------ ground truth
class Frames(NamedTuple):
    """The ground-truth views and the seed cloud of one configuration."""

    key: tuple                      # frames_key() of the flags they serve
    cameras: list
    images: List[np.ndarray]        # [H, W, 3] float32 in [0, 1]
    seed_means: np.ndarray          # [N, 3]
    seed_rgb: Optional[np.ndarray]  # [N, 3] in [0.02, 0.98], or None


def frames_key(args: argparse.Namespace) -> tuple:
    return (bool(args.analytic_gt),
            args.scene_spheres if args.analytic_gt else None,
            args.width, args.height, args.seed_points, args.seed)


def make_scene(generator: torch.Generator, n_objects: int = 12,
               per_object: int = 1500, width: int = 640, height: int = 360,
               n_cams: int = N_CAMS, device=None):
    """Ground-truth parameters forming distinct anisotropic clusters and a
    ground slab, drawn from ``generator`` (a CPU generator), and the orbit
    cameras."""
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    def normal(shape):
        return torch.randn(shape, generator=generator)

    box = torch.tensor([1.2, 1.2, 0.5])
    parts = []
    for _ in range(n_objects):
        center = uniform((3,), -1.0, 1.0) * box
        color = uniform((1, 3), 0.1, 1.0)
        parts.append({
            "means": center + 0.15 * normal((per_object, 3)),
            "quats": normal((per_object, 4)),
            "scales": torch.log(uniform((per_object, 3), 0.004, 0.03)),
            "opacities": uniform((per_object, 1), 1.0, 4.0),
            "features_dc": (color - 0.5) / 0.2820948
            + 0.3 * normal((per_object, 3)),
        })
    ng = 4000
    parts.append({
        "means": torch.cat([uniform((ng, 2), -1.6, 1.6),
                            -0.7 + 0.01 * normal((ng, 1))], dim=1),
        "quats": torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(ng, 1),
        "scales": torch.log(torch.tensor([[0.05, 0.05, 0.004]])).repeat(
            ng, 1),
        "opacities": torch.full((ng, 1), 3.0),
        "features_dc": 0.2 * normal((ng, 3)),
    })
    gt = {k: torch.cat([p[k] for p in parts]).to(dev) for k in parts[0]}
    gt["features_rest"] = torch.zeros((gt["means"].shape[0], 0, 3),
                                      device=dev)
    cams = orbit_cameras(n_cams, radius=3.2, width=width, height=height,
                         focal=0.9 * width, device=dev)
    return gt, cams


def analytic_frames(width: int, height: int, seed_points: int, seed: int,
                    scene_spheres: int = 10, device=None,
                    key: tuple = ()) -> Frames:
    """The 64 orbit views of ``analytic.default_scene(seed=7)`` ray-traced
    on the host (the views in parallel threads: each is independent, so
    the images are those of a serial trace) and the seed cloud unprojected
    from their surface pixels."""
    dev = resolve_device(device)
    scene = analytic.default_scene(seed=7, n_spheres=scene_spheres)
    cams = orbit_cameras(N_CAMS, radius=3.2, width=width, height=height,
                         focal=0.9 * width, device=dev)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        renders = list(pool.map(
            lambda c: analytic.render_analytic(scene, c), cams))
    cloud = analytic.seed_points_from_views(scene, cams, renders,
                                            seed_points, seed=seed)
    return Frames(key, cams, [r["rgb"] for r in renders], cloud["points"],
                  np.clip(cloud["colors"], 0.02, 0.98))


def self_rendered_frames(width: int, height: int, seed_points: int,
                         seed: int, render_opts: RenderOptions, device=None,
                         key: tuple = ()) -> Frames:
    """``make_scene``'s clusters rendered by the model itself, and seed
    means drawn from its Gaussians with a little noise (no colours)."""
    dev = resolve_device(device)
    gt, cams = make_scene(torch.Generator().manual_seed(1), width=width,
                          height=height, device=dev)
    n_gt = gt["means"].shape[0]
    alive = torch.ones(n_gt, dtype=torch.bool, device=dev)
    eval_cfg = rade_gs.RadeGSConfig(sh_degree=0, background="black",
                                    render=render_opts,
                                    use_depth_normal_loss=False)
    with torch.no_grad():
        images = [rade_gs.get_outputs(gt, alive, c, 0, eval_cfg,
                                      training=False)[0]["rgb"].cpu().numpy()
                  for c in cams]
    g = torch.Generator().manual_seed(seed)
    sel = torch.randperm(n_gt, generator=g)[:seed_points]
    seed_means = gt["means"].cpu()[sel] + 0.02 * torch.randn(
        (seed_points, 3), generator=g)
    return Frames(key, cams, images, seed_means.numpy(), None)


def make_frames(args: argparse.Namespace, device=None) -> Frames:
    """The ground truth and seed cloud the flags ask for."""
    if args.analytic_gt:
        return analytic_frames(args.width, args.height, args.seed_points,
                               args.seed, args.scene_spheres, device,
                               key=frames_key(args))
    return self_rendered_frames(args.width, args.height, args.seed_points,
                                args.seed, render_options(args), device,
                                key=frames_key(args))


# ------------------------------------------------------------------ setup
def render_options(args: argparse.Namespace) -> RenderOptions:
    return RenderOptions(rasterize_mode="antialiased",
                         exact_binning=bool(args.exact_binning))


def extract_features(images: Sequence[np.ndarray], device,
                     names: Sequence[str] = EXTRACTORS):
    """Each image's maps {name: [C, h, w]} with the long edge brought down
    to 64, and the model's ``feature_dims``."""
    extractors = {nm: get_extractor(nm, device=str(device)) for nm in names}
    features = [{nm: _resize_chw(ex(np.asarray(im)), FEATURE_MAX_EDGE)
                 for nm, ex in extractors.items()} for im in images]
    dims = tuple((nm, tuple(features[0][nm].shape)) for nm in names)
    return features, dims


def model_config(args: argparse.Namespace, feature_dims=None):
    """RaDe-GS, or rade-features with ``feature_dims``: random background,
    the depth-normal loss from ``--reg-from``."""
    common = dict(sh_degree=args.sh_degree, background="random",
                  render=render_options(args), use_depth_normal_loss=True,
                  regularization_from_iter=args.reg_from)
    if feature_dims is not None:
        return rade_features.RadeFeaturesConfig(feature_dims=feature_dims,
                                                **common)
    return rade_gs.RadeGSConfig(**common)


def init_params(seed_means: np.ndarray, seed_rgb: Optional[np.ndarray],
                sh_degree: int, capacity: int, device=None,
                feature_cfg=None, seed: int = 42):
    """The seeded initialization: means from the cloud; the DC term from
    the point colours (``rgb_to_sh0`` at sh_degree > 0, the logit at 0),
    zero without colours; identity rotations, scales 0.02, logit opacity
    0; with ``feature_cfg`` zero latents and a decoder drawn from a
    generator seeded with ``seed + 1``; padded to ``max(capacity, N)``.
    Returns (params, alive, decoder or None)."""
    dev = resolve_device(device)
    n = len(seed_means)
    means = torch.as_tensor(np.asarray(seed_means, np.float32), device=dev)
    if seed_rgb is None:
        dc = torch.zeros((n, 3), device=dev)
    else:
        rgb = torch.as_tensor(np.asarray(seed_rgb, np.float32), device=dev)
        dc = rgb_to_sh0(rgb) if sh_degree > 0 \
            else torch.log(rgb / (1.0 - rgb))
    init = {
        "means": means,
        "quats": torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(
            n, 1),
        "scales": torch.log(torch.full((n, 3), 0.02, device=dev)),
        "opacities": torch.zeros((n, 1), device=dev),
        "features_dc": dc,
        "features_rest": torch.zeros((n, num_sh_bases(sh_degree) - 1, 3),
                                     device=dev),
    }
    decoder = None
    if feature_cfg is not None:
        init, decoder = rade_features.init_feature_params(
            init, feature_cfg,
            torch.Generator(device=dev).manual_seed(seed + 1))
    capacity = max(capacity, n)
    alive = torch.arange(capacity, device=dev) < n
    return pad_to_capacity(init, capacity), alive, decoder


def trainer_config(args: argparse.Namespace, model) -> TrainerConfig:
    return TrainerConfig(
        model=model,
        strategy=SCHEDULE,
        max_iterations=args.steps,
        num_downscales=args.num_downscales,
        resolution_schedule=args.res_schedule,
        seed=args.seed,
        scene_scale=1.2,
    )


def make_trainer(args: argparse.Namespace, frames: Frames,
                 device=None) -> Trainer:
    """A trainer over ``frames`` at the seeded initialization."""
    dev = resolve_device(device)
    features, dims = (extract_features(frames.images, dev)
                      if args.features else (None, None))
    cfg = model_config(args, dims)
    init, alive, decoder = init_params(
        frames.seed_means, frames.seed_rgb, args.sh_degree, args.capacity,
        dev, cfg if args.features else None, args.seed)
    groups = dict(optim.RADE_FEATURES_GROUPS) if args.features else None
    return Trainer(trainer_config(args, cfg), frames.cameras, frames.images,
                   init, alive, groups=groups, features=features,
                   decoder=decoder, device=dev)


def resume(tr: Trainer, path: Path) -> Path:
    """Restore ``tr`` from a checkpoint, or from a run directory's latest;
    returns the checkpoint's path."""
    if path.is_dir():
        found = latest_checkpoint(path)
        if found is None:
            raise SystemExit(f"no checkpoint under {path}")
        path = found
    tr.restore(path)
    return path


def truncate_history(out: Path, step: int) -> int:
    """Drop the rows of ``out/history.jsonl`` past ``step`` (a resume from
    an older checkpoint would otherwise duplicate steps); the whole file
    moves to ``history_prekill.jsonl`` first.  Returns the rows dropped."""
    hist_path = out / "history.jsonl"
    if not hist_path.exists():
        return 0
    lines = hist_path.read_text().splitlines()
    kept = [ln for ln in lines if json.loads(ln).get("step", 0) <= step]
    if len(kept) != len(lines):
        (out / "history_prekill.jsonl").write_text("\n".join(lines) + "\n")
        hist_path.write_text(("\n".join(kept) + "\n") if kept else "")
    return len(lines) - len(kept)


# ------------------------------------------------------------------- loop
class RunResult(NamedTuple):
    trainer: Trainer
    summary: Optional[Dict]       # None when the run stopped early
    step_ms: List[float]          # per step: CUDA events on the card
    eval_s: List[float]           # per eval point, host clock
    save_s: List[float]           # per checkpoint, host clock
    evals: List[Dict]             # step, eval_psnr, eval_ssim, N per eval


class _StepClock:
    """Per-step times: CUDA events around each step on the card (read once
    at the end, so timing adds no synchronisation), the host clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, begin) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.marks.append((begin, end))
        else:
            self.marks.append((time.perf_counter() - begin) * 1e3)

    def ms(self) -> List[float]:
        if not self.cuda:
            return list(self.marks)
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.marks]


def _row(m: Dict) -> str:
    return json.dumps({k: (float(v) if isinstance(v, (int, float, np.floating))
                           else v) for k, v in m.items()})


def run(args: argparse.Namespace, frames: Optional[Frames] = None,
        stop_after: Optional[int] = None,
        log: Callable[[str], None] = print) -> RunResult:
    """The training run of ``args``; ``frames`` reuses a ground truth made
    for the same flags.  With ``stop_after`` the run ends after that step
    as a kill would: no final evaluation and no summary."""
    # The card unless --cpu; raises when there is none.
    dev = resolve_device("cpu" if args.cpu else None)
    log(f"platform: {dev.type}")
    if frames is None:
        log("making ground-truth frames...")
        frames = make_frames(args, dev)
    elif frames.key != frames_key(args):
        raise ValueError(f"frames made for {frames.key}, the flags ask for "
                         f"{frames_key(args)}")
    cams = frames.cameras
    args.out.mkdir(parents=True, exist_ok=True)
    hist_path = args.out / "history.jsonl"
    tr = make_trainer(args, frames, dev)
    if args.resume is not None:
        path = resume(tr, args.resume)
        log(f"resumed from {path} at step {tr.step}")
        dropped = truncate_history(args.out, tr.step)
        if dropped:
            log(f"truncated history to step {tr.step} ({dropped} rows moved "
                "to history_prekill.jsonl)")

    t0 = time.time()
    peak_n, spill_seen, nonfinite_seen = args.seed_points, 0, 0
    recent: List[Dict] = []
    clock = _StepClock(dev)
    eval_s, save_s, evals = [], [], []
    stride = max(len(cams) // max(args.eval_cams, 1), 1)
    mode = "a" if args.resume is not None else "w"
    # Line-buffered: a kill loses at most the row being written.
    with open(hist_path, mode, buffering=1) as hf:
        for _ in range(tr.step, args.steps):
            ts = time.time()
            begin = clock.start()
            m = tr.train_one_step()
            clock.stop(begin)
            m["step"] = tr.step
            m["wall_s"] = time.time() - ts
            peak_n = max(peak_n, m["num_gaussians"])
            spill_seen = max(spill_seen, int(m.get("spilled", 0)))
            nonfinite_seen += int(m.get("nonfinite_grad", 0))
            if args.save_every and tr.step % args.save_every == 0:
                t1 = time.perf_counter()
                tr.save(args.out)       # <out>/step-XXXXXXXX.ckpt.npz
                save_s.append(time.perf_counter() - t1)
            if tr.step % args.eval_every == 0 or tr.step == args.steps:
                t1 = time.perf_counter()
                evs = [tr.eval_image(c, im) for c, im in
                       zip(cams[::stride], tr.images[::stride])]
                # Every key the evaluation reports (LPIPS too, when its
                # weights are found); the row keeps PSNR and SSIM.
                ev = {k: float(np.mean([e[k] for e in evs])) for k in evs[0]}
                eval_s.append(time.perf_counter() - t1)
                m["eval_psnr"] = ev["psnr"]
                m["eval_ssim"] = ev["ssim"]
                evals.append({"step": tr.step, "eval_psnr": ev["psnr"],
                              "eval_ssim": ev["ssim"],
                              "num_gaussians": m["num_gaussians"]})
                el = time.time() - t0
                log(f"step {tr.step:6d}  psnr {ev['psnr']:6.2f}  "
                    f"N {m['num_gaussians']:7d}  cap "
                    f"{tr.alive.shape[0]:7d}  spill {m.get('spilled', 0)}  "
                    f"nfg {nonfinite_seen}  ds {tr.downscale_factor()}  "
                    f"{tr.step / el:5.1f} it/s  [{el:7.1f}s]")
            hf.write(_row(m) + "\n")
            recent.append(m)
            if stop_after is not None and tr.step >= stop_after:
                return RunResult(tr, None, clock.ms(), eval_s, save_s, evals)

    evs = [tr.eval_image(c, im) for c, im in
           zip(cams[::FINAL_EVAL_STRIDE], tr.images[::FINAL_EVAL_STRIDE])]
    summary = {
        "steps": args.steps,
        "width": args.width, "height": args.height,
        "analytic_gt": bool(args.analytic_gt),
        "sh_degree": int(args.sh_degree),
        "features": bool(args.features),
        "exact_binning": bool(args.exact_binning),
        "final_psnr_mean": float(np.mean([e["psnr"] for e in evs])),
        "final_ssim_mean": float(np.mean([e["ssim"] for e in evs])),
        "peak_gaussians": int(peak_n),
        "final_gaussians": int(recent[-1]["num_gaussians"]),
        "capacity": int(tr.alive.shape[0]),
        "max_spill_seen": int(spill_seen),
        "nonfinite_grad_steps": int(nonfinite_seen),
        "wall_clock_s": time.time() - t0,
        "steady_it_per_s": float(
            1.0 / np.median([r["wall_s"] for r in recent[-2000:]])),
        "reg_phase_steps": max(args.steps - args.reg_from, 0),
    }
    (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
    log(json.dumps(summary, indent=1))
    return RunResult(tr, summary, clock.ms(), eval_s, save_s, evals)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    run(args, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

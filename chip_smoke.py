"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the port's six CUDA kernels from ``collab_splats_tpu_torch/csrc``
and holds each against its plain PyTorch version on the card (the per-tile
pair, which reads each slot's row through the aligned ids, at C = 3 and 16
colour channels and stop_threshold 0 and 1e-4 with a nonzero per-slot sink;
the four compositing kernels also on the seeded edge cases of
``data/compositing_cases.py``; the decode also on the skewed plans of
``data/decode_plans.py``; the sorted segment sum also on a skewed id
stream: one id owning 2^17 rows, a run of 120,000 ids owning none), and the
``backend="pallas"`` render against the ``"xla"`` render.  Then it drives
the port's thirteen main paths:

1. the forward render (``models/rade_gs.py::get_outputs``) on the flagship
   scene (20,000 Gaussians, 512x512) and on the bench scene (1M Gaussians,
   1280x720, four orbit cameras);
2. the training step (``train/trainer.py::Trainer``) at the bench scene's
   full width with sh_degree 3: twenty steps, the depth-normal loss off and
   then on, one opacity reset and one refine pass; then one step repeated
   from the same state, which must give the same bits, and a fitting run at
   the flagship scale whose PSNR must rise by 3 dB;
3. the render of both scenes with ``RenderOptions(backend="pallas")``;
4. the training step with ``backend="pallas"`` at the bench scene's width:
   fourteen steps with the reset, the depth-normal loss and a refine pass
   reading ``update_state_from_isect``, and a repeated step;
5. rade-features training (``get_method("rade-features")``: 13 latents,
   the decoder, clip-vit 768 and dinov2 384 feature maps at 64x36) on the
   bench scene at 1280x720 with ``backend="xla"``: twenty steps with the
   reset, the depth-normal loss and a refine pass, every kernel held
   against its plain version on a step's own inputs (kernels 2 and 3 at
   V = 19, kernel 4 at D = 28 and 2), a falling feature loss and a
   repeated step; a checkpoint at step 12 through ``checkpoint_fn``, from
   which a fresh trainer resumes and must reach step 20 with the same bits;
6. the same with ``backend="pallas"`` (kernels 5 and 6 at C = 16, kernel 4
   at D = 32 and 2) for fourteen steps; then six steps of progressive
   resolution (factors 4, 2, 1: camera, box-filtered ground truth and
   launches at each);
7. mesh extraction (``meshing/exporters.py``): path 5's checkpoint restored
   with ``load_checkpoint`` and fused by ``TSDFFusionExporter`` over the
   four bench cameras at 1280x720 (depth_trunc 6.0 for the radius-3 orbit,
   the 13-channel feature volume on), writing splats.ply, mesh.ply and
   mesh_features.npz; the export repeated to the same volume bits and the
   same mesh.ply bytes; ``GaussiansToPoissonExporter`` at grid 256 on the
   same splat, its trilinear splat's segment sums (kernel 4) bit-exact
   against the plain version and a repeated chi field bit-identical; then
   the TSDF exporter on a flat disk and the level-set and depth-and-normal
   Poisson exporters on the flagship scene, card against CPU, and the
   latter two at full size on the card, with each meshing layer's time;
8. the feature towers at their released shapes (CLIP ViT-L/14@336 and its
   text tower, DINOv2 ViT-S/14, SAM ViT-B, YOLOv8x), with seeded weights
   written in the converters' npz layouts to a temporary directory and
   loaded through the entry points' weights files: ``FeatureDatamanager``
   extracts clip-vit [768, 35, 64] and dinov2 [384, 32, 57] maps from the
   four bench images (cached and read back to the same bits), twelve
   rade-features steps train on them, the text tower embeds seeded ids
   that ``query_vertices`` and ``similarity_map`` score against path 7's
   mesh and a rendered view, and ``GroupingClassifier`` groups the bench
   scene's 1M Gaussians over the four views, segmented by SAM prompted
   with YOLOv8 boxes; the extraction, segmentation and grouping repeated
   to the same bits, and each tower held card against CPU;
9. the trainer's options on path 2's scene (1M Gaussians at capacity
   1,262,144, sh_degree 3, 1280x720, four cameras): twelve steps with
   ``optimize_camera_poses`` and ``use_bilateral_grid``, the depth-normal
   loss from step 4, an eval image every four steps with LPIPS on seeded
   VGG16 weights (the converter's layout, found through
   ``COLLAB_SPLATS_WEIGHTS``), JSONL and TensorBoard writers read back, and
   ``dataset_hbm_budget_bytes=0`` so every frame streams from pinned host
   memory; the same steps cached on the card give the same bits, a
   repeated step too, every kernel holds on a step's own inputs,
   ``render_tiled_batch`` equals four single renders, and each option's
   layer is timed;
10. the ``Splatter`` pipeline on a dataset that ``write_synthetic_dataset``
   renders from the bench scene (ten orbit cameras at 1280x720 through the
   port's PNG codec, 262,144 means in sparse.ply): RaDe-GS at capacity
   1,048,576 and sh_degree 3 trained to step 10, then asked for 20 (the
   resume reaches the bits of 20 steps at once), ``mesh()`` (TSDF with
   floor alignment; a second call skips), ``load_model``,
   ``load_aligned_cameras``, ``plot_mesh``, one HTTP request to the viewer
   (its PNG equal to the direct render), rade-features with the towers'
   seeded weights (12 steps, a mesh, ``query_mesh`` in [0, 1] and
   repeatable), and the CLI re-run skipping every stage;
11. multi-device training (``parallel/``) on a 1x1 mesh under NCCL in
   this process (world size 1: every collective is a copy): the bench
   training scene at capacity 1,262,144, ten all-gather sharded steps with
   one sharded refine, ten tile-sharded steps at send_cap = shard and two
   at shard / 8; the first step's loss and pre-Adam gradients against the
   single-device step, the routed step against the all-gather one, a
   repeated step's bits, kernels 1-4 on both steps' own inputs, and the
   step times (``utils/profiling.py``) beside the single-device step's;
12. ``render_golden`` on the card at 4,096 Gaussians and 512x512, both
   tiled renderers held against it, then the analytic scene
   (``data/analytic.py``: eight 640x480 views ray-traced on the host,
   100,000 seed points) fitted for 300 steps (mean training-view PSNR up
   by 3 dB) and meshed, the mesh's accuracy and completeness printed;
13. the entry points of ``collab_splats_tpu_torch/scripts/`` in this
   process at the reference run's width (the analytic scene's 64 views at
   640x360 ray-traced once, sh_degree 3, exact binning, 30,000 seeds,
   capacity 262,144): ``scale_train`` over a shortened schedule (3,200
   steps: downscale 4 -> 2 -> 1, SH degrees 1-3, refines from step 600,
   the opacity reset at 3,100, the depth-normal phase from 2,200), a
   fresh trainer resumed from step 2,000 and stopped after 2,400 whose
   rows equal the first run's bit for bit, ``mesh_eval`` on the step-3,000
   checkpoint, a 500-step ``--features`` leg and ``feature_chain_eval`` on
   its checkpoint; kernels 1-4 held on one of its steps.

It checks what comes out, the kernels each path launches (path 7 needs
``cpp/libmesh_repair.so``, built at first use), and prints
per-layer and per-kernel timings (the segment sum at the expand_rows
backward's D = 15 rows and the statistic's D = 2 rows, each beside
``index_add_``), with the share of (warp, slot) pairs in which each
compositing backward finds a live pixel and the share of pairs that the
batched forward's cull decides without exp.

Run it from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Any failure raises and exits non-zero.  The last line of a successful run
is ``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches on a main path, its error against its plain version,
and its times beside its bound.
"""

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from collab_splats_tpu_torch.core import compositing
from collab_splats_tpu_torch.core.options import RenderOptions
from collab_splats_tpu_torch.core.projection import (covariance3d,
                                                     project_gaussians)
from collab_splats_tpu_torch.data import (compositing_cases, decode_plans,
                                          synthetic)
from collab_splats_tpu_torch.data.datamanager import FullImageDatamanager
from collab_splats_tpu_torch.features import datamanager as feature_dm
from collab_splats_tpu_torch.features import decoder as decoder_lib
from collab_splats_tpu_torch.features import (extractors, grouping,
                                              sam_predictor, segmentation,
                                              vit, yolo)
from collab_splats_tpu_torch.features import sam as sam_mod
from collab_splats_tpu_torch.meshing import _native as mesh_native
from collab_splats_tpu_torch.meshing import exporters, poisson
from collab_splats_tpu_torch.meshing import transfer as mesh_transfer
from collab_splats_tpu_torch.models import gaussians, rade_features, rade_gs
from collab_splats_tpu_torch.ops import rasterize, segsum, tiles
from collab_splats_tpu_torch.ops.cuda import (batched, binning_kernel, build,
                                              composite, segsum_kernel)
from collab_splats_tpu_torch.pipeline.methods import get_method
from collab_splats_tpu_torch.train import checkpoint, strategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig
from collab_splats_tpu_torch.utils import profiling

# One H100 SXM at its full 700 W limit (NVIDIA's data sheet): the rates
# the bounds below are computed from.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TOL = dict(rtol=1e-5, atol=1e-5)
# Gradients: rtol 5e-4 and atol 5e-5 * max|g| (tests/test_pallas.py:205-206).
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
REPS = 10
PLAIN_REPS = 3     # the plain versions of the backward run for seconds
TRAIN_STEPS = 20
REG_FROM = 10      # the depth-normal loss from this step on
REFINE_EVERY = 8   # opacity reset after step 8, refine pass after step 16
# The backend="pallas" training path: opacity reset after step 4, refine
# pass after step 12, two steps at the grown capacity.
PALLAS_STEPS = 14
PALLAS_REG_FROM = 6
PALLAS_REFINE_EVERY = 4
PALLAS_REFINE_AT = 12
FIT_STEPS = 300
RENDER_REPS = 30   # the host-clock render time spreads more than a kernel's
TS = 16
NEAR = RenderOptions().near_plane
KEYS = ("rgb", "depth", "median_depth", "normals", "accumulation")
CARD = ""


def say(msg: str) -> None:
    print(f"{msg} [{CARD}]", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timings(fn, host_clock=False, reps=REPS):
    """``reps`` synchronised timings of ``fn`` in ms, after one warm-up:
    CUDA events around a kernel, the host clock around a whole render."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if host_clock:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return times


def median_ms(fn, host_clock=False, reps=REPS):
    return statistics.median(timings(fn, host_clock, reps))


def traced_totals(fn, reps=3):
    """(reps, the program's span and counter totals) of ``reps`` calls of
    ``fn``, each in the span ``smoke.call``, after one untraced call, read
    inside ``utils/profiling.trace`` (into a temporary directory)."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d, profiling.trace(d):
        for _ in range(reps):
            with profiling.span("smoke.call"):
                fn()
        return reps, profiling.totals()


def say_totals(what, traced, say):
    """One line of :func:`traced_totals`: per call, each span's card ms
    (its stretch of the device timeline), host ms and count, by card
    time, then the counters."""
    reps, totals = traced
    spans = sorted(totals["spans"].items(),
                   key=lambda kv: -(kv[1]["card_s"] or 0.0))
    say(f"{what} (utils/profiling spans per call: card ms / host ms / "
        f"count): " + "; ".join(
            f"{k} {(v['card_s'] or 0.0) * 1e3 / reps:.4f} / "
            f"{v['host_s'] * 1e3 / reps:.4f} / {v['count'] / reps:g}"
            for k, v in spans)
        + "; counters per call: " + ", ".join(
            f"{k} {v / reps:g}" for k, v in sorted(totals["counters"].items())))


def assert_grad_close(got, ref, what):
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * scale, msg=what)
    return float((got - ref).abs().max())


def make_scene(name: str, dev, n=None, width=None, height=None,
               sh_degree=0):
    """(params, alive, cameras, config) of the flagship or the bench scene,
    with random weights drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(0)
    if name == "flagship":
        # __graft_entry__.py::_flagship_scene.
        n, width, height = n or 20_000, width or 512, height or 512
        params = synthetic.random_gaussian_params(
            gen, n, extent=1.0, sh_degree=sh_degree, device=dev)
        cams = synthetic.orbit_cameras(1, radius=3.0, width=width,
                                       height=height, focal=1.2 * width,
                                       device=dev)
        opts = RenderOptions(rasterize_mode="antialiased")
    else:
        # bench.py's configuration: 1M Gaussians at 1280x720.
        n, width, height = n or 1_000_000, width or 1280, height or 720
        params = synthetic.random_gaussian_params(
            gen, n, extent=1.5, scale_range=(0.002, 0.006),
            sh_degree=sh_degree, device=dev)
        cams = synthetic.orbit_cameras(4, radius=3.0, width=width,
                                       height=height, focal=float(width),
                                       device=dev)
        opts = RenderOptions(rasterize_mode="antialiased", tile_capacity=512,
                             max_intersections=1 << 21, exact_binning=False)
    cfg = rade_gs.RadeGSConfig(sh_degree=sh_degree, background="black",
                               render=opts)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    return params, alive, cams, cfg


def render(params, alive, cam, cfg):
    return rade_gs.get_outputs(params, alive, cam, 0, cfg, training=False)


def pallas_config(cfg):
    """The scene's configuration with the per-tile compositor."""
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, backend="pallas"))


def kernel_inputs(params, alive, cam, cfg, latent_dim=13):
    """The decode plans (exact and quantized ranks) and the compositor's
    window rows and mask that the main path builds for this camera, with
    ``latent_dim`` extra value channels (13 gives rade-features' V = 19)."""
    _, meta = render(params, alive, cam, cfg)
    opts = cfg.render
    opac = gaussians.activated_opacity(params, alive)
    if opts.rasterize_mode == "antialiased":
        opac = opac * meta.proj.compensation
    plans = {
        exact: tiles.plan_bins(meta.proj, cam.width, cam.height,
                               dataclasses.replace(opts, exact_binning=exact),
                               opac)
        for exact in (True, False)
    }
    colors = rade_gs.compute_colors(params, cam, 0, cfg)
    gen = torch.Generator(device=colors.device).manual_seed(1)
    latents = torch.rand((colors.shape[0], latent_dim), generator=gen,
                         device=colors.device)
    per_gauss = rasterize.pack_per_gauss(
        meta.proj, opac, meta.proj.normal, torch.cat([colors, latents], 1))
    g = rasterize.window_rows(meta.bins, per_gauss)
    return plans, g, meta.bins.tile_mask.to(torch.float32), \
        meta.bins.num_tiles_x


def decode_args(plan):
    return (plan.inputs, plan.m_cap, plan.ntx, TS, plan.rank_bits,
            plan.ntx * plan.nty)


def check_decode(plan, args=None) -> float:
    """The kernel's whole (key, gid) stream against the plain version's:
    bit-exact.  Returns the max abs difference (0)."""
    args = args or decode_args(plan)
    key, gid = binning_kernel.decode_bin_keys(*args)
    ref_key, ref_gid = binning_kernel.decode_keys_plain(*args)
    err = max(int((key - ref_key).abs().max()),
              int((gid - ref_gid).abs().max()))
    if err:
        bad = int(((key != ref_key) | (gid != ref_gid)).sum())
        raise AssertionError(f"decode: {bad} slots differ from the plain "
                             "version")
    return float(err)


def check_decode_plans(dev) -> float:
    """The decode on the skewed plans of ``data/decode_plans.py``, each
    with the cull and without: bit-exact."""
    for name, p in decode_plans.skewed_plans(dev).items():
        for d in (p.inputs, p.inputs._replace(cull=None)):
            check_decode(None, (d, p.m_cap, p.ntx, p.ts, p.rank_bits,
                                p.num_tiles))
    say("parity decode on the skewed plans (runs of zero-count gaussians, "
        "one gaussian owning 1,500 slots, live totals below and equal to "
        f"the capacity {decode_plans.M_CAP}; cull on and off): bit-exact")
    return 0.0


def check_composite(g, mask, ntx):
    """The forward kernel's maps against the plain version's within
    rtol/atol 1e-5, its median slot (at every covered pixel) and banked
    prefix bit-identical.  Returns the max abs difference and the kernel's
    outputs."""
    got = batched.composite_batched_fwd(g, mask, ntx, TS, NEAR,
                                        bank_prefix=True)
    ref = compositing.fused_forward(g, mask, ntx, TS, NEAR, tile_chunk=256,
                                    bank_prefix=True)
    for name, a, b in zip(("out_v", "alpha", "depth_acc", "median", "",
                           "prefix"), got, ref):
        if name:
            torch.testing.assert_close(a, b, msg=f"composite {name}", **TOL)
    hit = got[1] > 0
    bad_idx = int((got[4] != ref[4])[hit].sum())
    bad_prefix = int((got[5] != ref[5]).sum())
    say(f"  composite V={g.shape[2] - 9}: med_idx differs from the plain "
        f"version at {bad_idx} of {int(hit.sum())} covered pixels; banked "
        f"prefix differs at {bad_prefix} of {got[5].numel()} entries")
    if bad_idx or bad_prefix:
        raise AssertionError("composite: med_idx or the banked prefix is not "
                             "bit-identical to the plain version")
    err = max(float((a - b).abs().max())
              for i, (a, b) in enumerate(zip(got, ref)) if i != 4)
    return err, got


def bwd_inputs(g, mask, ntx, fwd, seed):
    """The backward kernel's arguments for the forward outputs ``fwd``
    (banked), with seeded normal cotangents."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    t, p, v = g.shape[0], TS * TS, g.shape[2] - 9
    cots = [torch.randn((t, p, v), generator=gen, device=g.device)] + [
        torch.randn((t, p), generator=gen, device=g.device)
        for _ in range(3)]
    return (g, mask, fwd[5], *cots, fwd[4], 1.0 - fwd[1], ntx, TS, NEAR)


# d_g's column groups (ops/rasterize.py::pack_per_gauss): each is held to
# the gradient tolerance scaled by its own max |ref|, since their scales
# differ by orders of magnitude.
DG_GROUPS = (("mean", 0, 2), ("conic", 2, 5), ("depth, plane", 5, 8),
             ("opacity", 8, 9), ("vals", 9, None))


def limit_share(got, ref) -> float:
    """The largest |got - ref| over its limit in the gradient tolerance
    (rtol 5e-4, atol 5e-5 * max |ref|): 1 at the limit."""
    lim = GRAD_ATOL * float(ref.abs().max()) + GRAD_RTOL * ref.abs()
    return float(((got - ref).abs() / lim).nan_to_num(0.0).max())


def check_composite_bwd(g, mask, ntx, fwd, seed, what) -> float:
    """The backward kernel against the plain backward on the forward
    outputs ``fwd`` with seeded cotangents (see check_composite_bwd_args)."""
    return check_composite_bwd_args(bwd_inputs(g, mask, ntx, fwd, seed),
                                    what)


def check_composite_bwd_args(args, what) -> float:
    """The backward kernel on its arguments ``args`` against the plain
    backward within the gradient tolerance for each column group, exactly 0
    at masked slots, and the same bits on a second launch.  Prints each
    group's error over its limit; returns the max abs difference."""
    g, mask, ntx = args[0], args[1], args[9]
    got = batched.composite_batched_bwd(*args)
    again = batched.composite_batched_bwd(*args)
    ref = compositing.fused_backward(g, mask, args[7], args[8], *args[3:7],
                                     ntx, TS, NEAR)
    err = max(assert_grad_close(
        got[..., a:b], ref[..., a:b],
        f"composite_bwd V={g.shape[2] - 9} d_g[{name}]")
        for name, a, b in DG_GROUPS)
    say(f"composite_bwd {what} V={g.shape[2] - 9}: error over its limit per "
        f"column group: " + ", ".join(
            f"{name} {limit_share(got[..., a:b], ref[..., a:b]):.4f}"
            for name, a, b in DG_GROUPS))
    if not torch.equal(got, again):
        raise AssertionError("composite_bwd: two launches differ")
    if bool((mask == 0).any()) and float(got[mask == 0].abs().max()) != 0:
        raise AssertionError("composite_bwd: nonzero gradient at a masked "
                             "slot")
    return err


def window_idx(bins, n):
    """The window gather's indices over ``n`` Gaussians, dead slots
    spread (``ops/rasterize.py::window_rows``)."""
    return segsum.spread_masked(bins.tile_gauss.reshape(-1),
                                bins.tile_mask.reshape(-1), n)


def segsum_inputs(idx, d, seed):
    """The expand_rows backward's sorted ids, permutation and seeded normal
    cotangent rows [M, d] for the gather indices ``idx`` [M]."""
    gen = torch.Generator(device=idx.device).manual_seed(seed)
    rows = torch.randn((idx.shape[0], d), generator=gen, device=idx.device)
    sorted_ids, order = torch.sort(idx, stable=True)
    return sorted_ids, order, rows


def close_1e6(got, ref, what) -> float:
    """Exact sums on both sides: rtol 1e-6 and atol 1e-6 * max |ref|."""
    torch.testing.assert_close(got, ref, rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()), msg=what)
    return float((got - ref).abs().max())


def check_segsum_rows(sorted_ids, order, rows, n, what) -> float:
    """The segment-sum kernel against its plain version: the same bits
    (both sum each segment in sorted order, unsplit), and the same bits on
    a second launch."""
    got = segsum_kernel.segment_sum_sorted(sorted_ids, order, rows, n)
    again = segsum_kernel.segment_sum_sorted(sorted_ids, order, rows, n)
    ref = segsum_kernel.segment_sum_plain(sorted_ids, order, rows, n)
    if not torch.equal(got, again):
        raise AssertionError(f"segment_sum {what}: two launches differ")
    if not torch.equal(got, ref):
        raise AssertionError(f"segment_sum {what}: not bit-identical to the "
                             f"plain version (max abs err "
                             f"{float((got - ref).abs().max()):.3g})")
    return 0.0


def check_segsum(bins, n, d=15) -> float:
    sorted_ids, order, rows = segsum_inputs(window_idx(bins, n), d, seed=5)
    return check_segsum_rows(sorted_ids, order, rows, n, f"D={d}")


# Id streams at the xla train step's size.  The skewed one: one gaussian
# that owns 2^17 rows, a run of ids that own none, the last id owned, and an
# M that is no multiple of a block.  The tile-length one: a gaussian owns at
# most one row per tile (3,600 at 1280x720), and TILE_LONG_IDS gaussians
# own that many here, as gaussians that cover the whole image would.
SKEW_N, SKEW_M = 1_262_144, 3600 * 512 + 77
SKEW_LONG, SKEW_EMPTY = (5, 1 << 17), (400_000, 520_000)
TILE_ROWS, TILE_LONG_IDS = 3600, 16


def skewed_ids(dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(9)
    idx = torch.randint(0, SKEW_N, (SKEW_M,), generator=gen, device=dev,
                        dtype=torch.int32)
    lo, hi = SKEW_EMPTY
    idx = torch.where((idx >= lo) & (idx < hi), idx - (hi - lo), idx)
    idx[-1000:-900] = SKEW_N - 1
    gid, count = SKEW_LONG
    idx[:count] = gid
    return idx


def tile_length_ids(dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(11)
    idx = torch.randint(0, SKEW_N, (SKEW_M,), generator=gen, device=dev,
                        dtype=torch.int32)
    # Even ids own TILE_ROWS rows each; the other rows move off them.
    gids = 2 * torch.randperm(SKEW_N // 2, generator=gen,
                              device=dev)[:TILE_LONG_IDS].int()
    idx = torch.where(torch.isin(idx, gids), idx + 1, idx)
    idx[:TILE_LONG_IDS * TILE_ROWS] = gids.repeat_interleave(TILE_ROWS)
    return idx


def long_rows_share(idx, n):
    """The longest segment of the ids ``idx`` and the share of their rows
    in segments over LONG_ROWS rows (those the kernel sums by a block)."""
    counts = torch.bincount(idx, minlength=n)
    long = counts[counts > segsum_kernel.LONG_ROWS]
    return int(counts.max()), float(long.sum()) / idx.shape[0]


def stream_args(idx, seed):
    """The segment sum's arguments for the ids ``idx`` with seeded normal
    rows, at D = 15 and D = 2."""
    sorted_ids, order = torch.sort(idx, stable=True)
    return {d: (sorted_ids, order, torch.randn(
        (idx.shape[0], d), device=idx.device,
        generator=torch.Generator(device=idx.device).manual_seed(seed + d)),
        SKEW_N) for d in (15, 2)}


def check_segsum_streams(dev) -> float:
    """Kernel 4 against its plain version on the skewed and the
    tile-length streams at D = 15 and D = 2, bit-identical and with a
    bit-identical repeat; on the tile-length stream also with every
    segment left to the group walk (long_rows = TILE_ROWS), timed both ways
    beside index_add_."""
    idx = skewed_ids(dev)
    counts = torch.bincount(idx, minlength=SKEW_N)
    lo, hi = SKEW_EMPTY
    if not (int(counts[SKEW_LONG[0]]) >= SKEW_LONG[1]
            and int(counts[lo:hi].sum()) == 0 and int(counts[-1]) > 0):
        raise AssertionError("skewed segment-sum stream is not skewed")
    for d, args in stream_args(idx, 10).items():
        check_segsum_rows(*args, f"skewed D={d}")
    say(f"parity skewed stream: segment_sum at N={SKEW_N}, M={SKEW_M}, one "
        f"id owning {int(counts.max())} rows, ids {lo}..{hi - 1} owning none, "
        f"id N-1 owning {int(counts[-1])}: bit-identical to the plain version "
        f"at D=15 and D=2, repeats bit-identical")

    tidx = tile_length_ids(dev)
    longest, share = long_rows_share(tidx, SKEW_N)
    if longest != TILE_ROWS:
        raise AssertionError(f"tile-length stream: longest segment {longest}")
    times = []
    for d, args in stream_args(tidx, 20).items():
        check_segsum_rows(*args, f"tile-length D={d}")
        walk = segsum_kernel.segment_sum_sorted(*args, long_rows=TILE_ROWS)
        if not torch.equal(walk, segsum_kernel.segment_sum_plain(*args)):
            raise AssertionError(f"segment_sum tile-length D={d}: the group "
                                 "walk alone is not bit-identical")
        calls = {
            "kernel": lambda: segsum_kernel.segment_sum_sorted(*args),
            "group walk alone": lambda: segsum_kernel.segment_sum_sorted(
                *args, long_rows=TILE_ROWS),
            "index_add_": lambda: torch.zeros(
                (SKEW_N, d), device=dev).index_add_(0, tidx.long(), args[2]),
        }
        times.append(f"D={d}: " + ", ".join(
            f"{k} {median_ms(f):.4f} ms" for k, f in calls.items()))
    say(f"parity tile-length stream: segment_sum at N={SKEW_N}, M={SKEW_M}, "
        f"{TILE_LONG_IDS} ids owning {TILE_ROWS} rows each ("
        f"{100 * share:.2f}% of the rows in segments over "
        f"{segsum_kernel.LONG_ROWS}): bit-identical to the plain version, "
        f"with and without the block path; time (median of {REPS}) "
        + "; ".join(times))
    return 0.0


def check_segsum_step(tr) -> float:
    """Kernel 4 at the train step's own shapes, on the trainer's current
    state (N = its capacity), for both of the step's launches: the
    expand_rows backward (seeded normal rows, D = 15) and update_state (the
    masked |sink gradient| rows of one real backward, D = 2).  Each is held
    against the plain version with a bit-identical repeat, and
    update_state's statistics against the same statistics from the plain
    sums (rtol 1e-6)."""
    cfg = tr.config.model
    cam, alive, st = tr.cameras[0], tr.alive, tr.strat_state
    n = alive.shape[0]
    sink = torch.zeros(sink_shape(cam, n, cfg.render), device=alive.device,
                       requires_grad=True)
    out, meta = rade_gs.get_outputs(tr.params, alive, cam, tr.step, cfg,
                                    training=True, compute_error_maps=True,
                                    absgrad_sink=sink)
    loss, _ = rade_gs.get_loss(out, tr.images[0], tr.params, alive, tr.step,
                               cfg, reg_active=True)
    (sink_grad,) = torch.autograd.grad(loss, [sink])
    idx = window_idx(meta.bins, n)
    sorted_ids, order, rows15 = segsum_inputs(idx, 15, seed=8)
    mask = meta.bins.tile_mask.reshape(-1)
    rows2 = torch.where(mask[:, None], sink_grad.abs().reshape(-1, 2),
                        torch.zeros((), device=alive.device))
    err = max(check_segsum_rows(sorted_ids, order, rows15, n, "D=15"),
              check_segsum_rows(sorted_ids, order, rows2, n, "D=2"))
    got = strategy.update_state(st, meta, sink_grad)
    again = strategy.update_state(st, meta, sink_grad)
    ref = strategy._accumulate(st, meta, segsum_kernel.segment_sum_plain(
        sorted_ids, order, rows2, n))
    for name, a, b, r in zip(strategy.StrategyState._fields, got, again, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"update_state {name}: two calls differ")
        err = max(err, close_1e6(a, r, f"update_state {name}"))
    longest, share = long_rows_share(idx, n)
    say(f"parity train step: segment_sum at N={n}, M={rows2.shape[0]} "
        f"(D=15 expand_rows rows, D=2 |sink gradient| rows of step "
        f"{tr.step}) and update_state against the plain sums: max abs err "
        f"{err:.3g}, repeats bit-identical; longest segment {longest} rows, "
        f"{100 * share:.4f}% of the rows in segments over "
        f"{segsum_kernel.LONG_ROWS}")
    return err


def parity(name, scene):
    """Each kernel against its plain version at the scene's shapes; returns
    the main path's decode plan, its V = 6 window rows, mask and ntx, and
    the max abs errors."""
    params, alive, cams, cfg = scene
    plans, g19, mask, ntx = kernel_inputs(params, alive, cams[0], cfg)
    g6 = g19[..., :15].contiguous()
    (e6, f6), (e19, f19) = (check_composite(g, mask, ntx) for g in (g6, g19))
    errs = {
        "decode": max(check_decode(p) for p in plans.values()),
        "composite": max(e6, e19),
        "composite_bwd": max(check_composite_bwd(g6, mask, ntx, f6, 1, name),
                             check_composite_bwd(g19, mask, ntx, f19, 2,
                                                 name)),
    }
    say(f"parity {name}: decode bit-exact with exact and quantized ranks "
        f"({plans[True].m_cap} slots); composite max abs err "
        f"{errs['composite']:.3g} (outputs and banked prefix), "
        f"composite_bwd max abs err {errs['composite_bwd']:.3g} (gradient "
        f"tolerance, masked slots 0, repeat bit-identical) at V=6 and V=19 "
        f"(T={g6.shape[0]}, K={g6.shape[1]})")
    return plans[cfg.render.exact_binning], g6, mask, ntx, errs


def bound(nbytes, ops):
    """(least ms, "bytes" | "operations") at the card's published rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_bound(plan):
    """Bytes, counted on this run's data: the int32 run ends of every
    gaussian (the binary search's array) read once; the offset, bbox width,
    first tile and rank, and with the cull its six float32 columns, read
    once for each gaussian that owns a slot; an int32 key and gid per slot
    written once.  Operations: about 60 float32 operations of the ellipse
    cull per live slot."""
    d = plan.inputs
    n = d.offsets.shape[0]
    owners = int((d.counts > 0).sum())
    per_owner = 4 * 4 + (6 * 4 if d.cull is not None else 0)
    nbytes = 4 * n + per_owner * owners + 8 * plan.m_cap
    live = int(d.counts.sum())
    return bound(nbytes, 60 * live if d.cull is not None else 0)


def tile_alphas(g, mask, ntx):
    """Each (pixel, window slot) pair's alpha, [Tc, P, K] for 64 tiles at
    a time, zero where it does not pass the cutoff."""
    for s in range(0, g.shape[0], 64):
        gg = g[s:s + 64]
        up, vp = compositing.pixel_centers(
            torch.arange(s, s + gg.shape[0], device=g.device), ntx, TS)
        yield compositing.splat_alpha(
            up[:, :, None] - gg[:, None, :, 0],
            vp[:, :, None] - gg[:, None, :, 1],
            gg[:, None, :, 2:5], gg[:, None, :, 8],
            mask[s:s + 64, None, :] > 0)


def live_pairs(g, mask, ntx) -> int:
    """(pixel, window slot) pairs whose alpha passes the cutoff."""
    return sum(int((a > 0).sum()) for a in tile_alphas(g, mask, ntx))


def live_warp_slots(g, mask, ntx):
    """(warp, window slot) pairs in which some pixel of the warp's 32 passes
    the alpha cutoff (the pairs kernel 3 reduces over a warp; its warps own
    8x4 blocks of the tile), and all (warp, masked-in slot) pairs."""
    live = sum(int(warp_blocks(a > 0).sum())
               for a in tile_alphas(g, mask, ntx))
    return live, TS * TS // 32 * int((mask > 0).sum())


def cull_shares(g, mask, ntx):
    """Of the (pixel, masked-in window slot) pairs: the share kernel 2
    decides without exp (sigma < 0, or beyond sigma_cut), and the share
    whose alpha passes the cutoff."""
    culled = live = 0
    for s in range(0, g.shape[0], 64):
        gg = g[s:s + 64]
        up, vp = compositing.pixel_centers(
            torch.arange(s, s + gg.shape[0], device=g.device), ntx, TS)
        du = up[:, :, None] - gg[:, None, :, 0]
        dv = vp[:, :, None] - gg[:, None, :, 1]
        sigma = 0.5 * (gg[:, None, :, 2] * du * du
                       + gg[:, None, :, 4] * dv * dv) \
            + gg[:, None, :, 3] * du * dv
        cut = compositing.sigma_cut(gg[..., 8])[:, None, :]
        m = mask[s:s + 64, None, :] > 0
        culled += int((((sigma < 0) | (sigma > cut)) & m).sum())
    for a in tile_alphas(g, mask, ntx):
        live += int((a > 0).sum())
    masked = TS * TS * int((mask > 0).sum())
    return culled / masked, live / masked


def composite_bound(g, mask, ntx):
    """Bytes: the window rows and the mask read once, the maps written
    once.  Operations, counted on this run's data: 23 float32 operations of
    alpha and depth per (pixel, live window slot) pair, and 11 + 2V more
    (transmittance, weight, value FMAs, median key) per pair whose alpha
    passes the cutoff."""
    t, k, d = g.shape
    v = d - 9
    nbytes = 4 * (t * k * d + t * k + t * TS * TS * (v + 4))
    masked = TS * TS * float(mask.sum())
    return bound(nbytes, 23 * masked + (11 + 2 * v) * live_pairs(g, mask, ntx))


def composite_bwd_bound(g, mask, ntx):
    """Bytes: the window rows, mask and banked prefix, the four cotangents,
    the median slot and T_total read once, d_g written once.  Operations,
    counted on this run's data: the 23 float32 operations of alpha and
    depth once per (pixel, live window slot) pair, and 37 + 4V more per
    pair whose alpha passes the cutoff: the transmittance (exp, log1p),
    r (V FMAs), d_alpha, d_tpix and d_sigma, the 9 + V products and the
    9 + V adds of the per-slot pixel sums."""
    t, k, d = g.shape
    v = d - 9
    p = TS * TS
    nbytes = 4 * (2 * t * k * d + t * k + -(-k // 64) * t * p
                  + t * p * (v + 5))
    masked = p * float(mask.sum())
    return bound(nbytes, 23 * masked + (37 + 4 * v) * live_pairs(g, mask, ntx))


def segsum_bound(m, d, n):
    """Bytes: the [M, d] float32 rows, the int32 sorted ids and the int64
    permutation read once, the [n, d] sums written once; one add per input
    element."""
    return bound(4 * m * d + 12 * m + 4 * n * d, m * d)


# ---------------------------------------------- the per-tile compositor
class TilesInputs:
    """Kernel 5's and 6's inputs for one camera: the padded per-gaussian
    rows, the aligned ids, the segments, and an optional per-slot sink
    [2, M]."""

    def __init__(self, per_gauss, ids, starts, lens, ntx, n_color,
                 max_chunks, sink=None):
        self.per_gauss, self.ids, self.sink = per_gauss, ids, sink
        self.starts, self.lens = starts, lens
        self.ntx, self.n_color, self.max_chunks = ntx, n_color, max_chunks

    @classmethod
    def of_render(cls, meta, opac, colors, k_cap):
        """The inputs as the ``backend="pallas"`` render builds them
        (``ops/rasterize.py::render_tiled_pallas``), without a sink."""
        gid, starts, lens, _ = tiles.align_segments(
            meta.bins.starts, meta.bins.sorted_gid, composite.CHUNK)
        with torch.no_grad():
            per_gauss = rasterize.pad_per_gauss(rasterize.pack_per_gauss(
                meta.proj, opac, meta.proj.normal, colors))
        return cls(per_gauss, gid, starts, lens,
                   meta.bins.num_tiles_x, colors.shape[1],
                   -(-k_cap // composite.CHUNK))

    @classmethod
    def of_matrix(cls, isect, starts, lens, ntx, n_color, max_chunks, seed):
        """The inputs whose slot s reads column s of a packed matrix
        [Dp, M]: its columns as the rows of a per-gaussian matrix in a
        seeded order, read through distinct ids."""
        d, m = isect.shape
        gen = torch.Generator(device=isect.device).manual_seed(seed)
        ids = torch.randperm(m, generator=gen, device=isect.device)
        per_gauss = torch.empty((m, d), device=isect.device)
        per_gauss[ids] = isect.T
        return cls(per_gauss, ids.to(torch.int32), starts, lens, ntx,
                   n_color, max_chunks)

    def with_sink(self, seed):
        """These inputs with a seeded nonzero sink (normal, 0.05 pixel)."""
        gen = torch.Generator(device=self.ids.device).manual_seed(seed)
        sink = 0.05 * torch.randn((2, self.ids.shape[0]), generator=gen,
                                  device=self.ids.device)
        return TilesInputs(self.per_gauss, self.ids, self.starts, self.lens,
                           self.ntx, self.n_color, self.max_chunks, sink)

    def rows(self, slots):
        """The rows the compositor reads at ``slots`` (any shape): the
        per-gaussian rows through the ids, the sink on (u, v)."""
        r = self.per_gauss[self.ids[slots].long()]
        if self.sink is not None:
            r = torch.cat([r[..., :2] + self.sink.T[slots], r[..., 2:]], -1)
        return r

    def fwd_args(self, stop):
        return (self.per_gauss, self.ids, self.starts, self.lens, self.ntx,
                TS, self.n_color, NEAR, stop, self.max_chunks, self.sink)

    def bwd_args(self, nchunks, seed):
        """Backward arguments for the forward's ``nchunks``, with seeded
        normal cotangents of the packed maps."""
        gen = torch.Generator(device=self.ids.device).manual_seed(seed)
        g = torch.randn((self.lens.shape[0], TS * TS, self.n_color + 6),
                        generator=gen, device=self.ids.device)
        return (self.per_gauss, self.ids, self.starts, self.lens, self.ntx,
                nchunks, g, TS, self.n_color, NEAR, self.max_chunks,
                self.sink)


def tiles_inputs(params, alive, cam, cfg):
    """TilesInputs of the scene's camera with RGB (C = 3) and with RGB
    and 13 seeded latents (C = 16, rade-features' width)."""
    _, meta = render(params, alive, cam, cfg)
    opac = gaussians.activated_opacity(params, alive)
    if cfg.render.rasterize_mode == "antialiased":
        opac = opac * meta.proj.compensation
    colors = rade_gs.compute_colors(params, cam, 0, cfg)
    gen = torch.Generator(device=colors.device).manual_seed(1)
    latents = torch.rand((colors.shape[0], 13), generator=gen,
                         device=colors.device)
    k_cap = cfg.render.tile_capacity or tiles.default_tile_capacity(
        alive.shape[0])
    return [TilesInputs.of_render(meta, opac, c, k_cap)
            for c in (colors, torch.cat([colors, latents], 1))]


def chunks_walked(ti):
    """[T] chunks each segment has, at most max_chunks: the walk without
    an early exit."""
    return torch.clamp((ti.lens + composite.CHUNK - 1) // composite.CHUNK,
                       max=ti.max_chunks)


def check_tiles_fwd(ti, stop):
    """Kernel 5 against its plain version: maps within rtol/atol 1e-5,
    nchunks equal, and alpha and the median bit-identical (the carry, the
    median slot and the maximum-weight decisions, and the slot's depth, are
    formed in the same rounding in both).  Returns (max abs err, nchunks,
    tiles that exited early)."""
    out, nch = composite.composite_tiles_fwd(*ti.fwd_args(stop))
    ref, ref_n = composite.composite_tiles_fwd_gather_plain(
        *ti.fwd_args(stop))
    what = f"composite_tiles C={ti.n_color} stop={stop}"
    if not torch.equal(nch, ref_n):
        raise AssertionError(f"{what}: nchunks differ at "
                             f"{int((nch != ref_n).sum())} tiles")
    torch.testing.assert_close(out, ref, msg=what, **TOL)
    for name, k in (("alpha", 3), ("median", 5)):
        c = ti.n_color + k
        if not torch.equal(out[..., c], ref[..., c]):
            raise AssertionError(
                f"{what}: {name} differs at "
                f"{int((out[..., c] != ref[..., c]).sum())} pixels")
    early = int((nch < chunks_walked(ti)).sum())
    return float((out - ref).abs().max()), nch, early


# d_slot's column groups (ops/cuda/composite.py's row layout), each held
# to the gradient tolerance scaled by its own max |ref|.
ISECT_GROUPS = (("mean", 0, 2), ("conic", 2, 5), ("depth, plane", 5, 8),
                ("opacity", 8, 9), ("normal", 9, 12), ("colour", 12, None))


def check_tiles_bwd(args, what) -> float:
    """Kernel 6 against its plain version on the arguments ``args`` within
    the gradient tolerance per column group, 0 in the padding columns, and
    the same bits on a second launch.  Returns the max abs difference."""
    got = composite.composite_tiles_bwd_call(*args)
    again = composite.composite_tiles_bwd_call(*args)
    ref = composite.composite_tiles_bwd_gather_plain(*args)
    n_color = args[8]
    cols = 12 + n_color
    err = max(assert_grad_close(
        got[:, a:b or cols], ref[:, a:b or cols],
        f"composite_tiles_bwd {what} C={n_color} d_slot[:, {name}]")
        for name, a, b in ISECT_GROUPS)
    if not torch.equal(got, again):
        raise AssertionError("composite_tiles_bwd: two launches differ")
    if bool(got[:, cols:].any()):
        raise AssertionError("composite_tiles_bwd: nonzero padding columns")
    return err


def tile_chunk_alphas(ti, nchunks):
    """Per group of tiles and chunk the forward ran: each (pixel, slot)
    pair's alpha [Tg, P, CHUNK], zero where it does not pass the cutoff,
    and which slots lie inside the segments [Tg, CHUNK]."""
    lane = torch.arange(composite.CHUNK, device=ti.ids.device)
    for ci in range(ti.max_chunks):
        t = torch.nonzero(nchunks > ci)[:, 0]
        for s in range(0, t.shape[0], 256):
            tt = t[s:s + 256]
            cols = ti.starts[tt].long()[:, None] + ci * composite.CHUNK + lane
            b = ti.rows(cols)[..., :9].permute(2, 0, 1)   # [9, Tg, CHUNK]
            inside = (ci * composite.CHUNK + lane)[None] < ti.lens[tt, None]
            up, vp = compositing.pixel_centers(tt, ti.ntx, TS)
            yield compositing.splat_alpha(
                up[:, :, None] - b[0][:, None], vp[:, :, None] - b[1][:, None],
                b[2:5].permute(1, 2, 0)[:, None], b[8][:, None],
                inside[:, None]), inside


def tiles_pairs(ti, nchunks):
    """(pixel, slot) pairs of the chunks the forward ran: inside the
    segments, and of those the pairs whose alpha passes the cutoff."""
    valid = live = 0
    for alpha, inside in tile_chunk_alphas(ti, nchunks):
        valid += TS * TS * int(inside.sum())
        live += int((alpha > 0).sum())
    return valid, live


def warp_blocks(live):
    """[T, P, K] pixel flags -> [T, 8, K]: whether some pixel of each
    warp's 8x4 block of the tile (as kernels 3 and 6 lay them out) is set."""
    t, k = live.shape[0], live.shape[2]
    blocks = live.reshape(t, 4, 4, 2, 8, k).permute(0, 1, 3, 2, 4, 5)
    return blocks.reshape(t, 8, 32, k).any(2)


def tiles_live_warp_slots(ti, nchunks):
    """(warp, slot) pairs of the chunks the forward ran in which some pixel
    of the warp passes the alpha cutoff (the pairs kernel 6 reduces over a
    warp), and all (warp, slot) pairs inside the segments."""
    live = valid = 0
    for alpha, inside in tile_chunk_alphas(ti, nchunks):
        live += int(warp_blocks(alpha > 0).sum())
        valid += TS * TS // 32 * int(inside.sum())
    return live, valid


def walked_slots(ti, nchunks) -> int:
    """Slots the compositor reads: those below each segment's length in
    the chunks it ran."""
    return int(torch.minimum(ti.lens, nchunks * composite.CHUNK).sum())


def slot_read_bytes(ti, nchunks) -> int:
    """Bytes of the rows the compositor reads: per walked slot its int32
    id, its Dp-float row and, with a sink, its two sink values."""
    per_slot = 4 + 4 * ti.per_gauss.shape[1] + (8 if ti.sink is not None
                                                 else 0)
    return per_slot * walked_slots(ti, nchunks)


def composite_tiles_bound(ti, nchunks):
    """Bytes: the rows of the slots the kernel walked read once (the id
    and the gathered row of each), starts and lens read, the packed maps
    and nchunks written once.  Operations, counted on this run's data: 23
    float32 operations of alpha and depth per (pixel, slot) pair inside a
    segment of those chunks, and 11 + 2(C + 3) more (transmittance, weight,
    value FMAs, median and maximum weight) per pair whose alpha passes the
    cutoff."""
    t, c = ti.lens.shape[0], ti.n_color
    nbytes = slot_read_bytes(ti, nchunks) + 4 * (
        2 * t + 1 + t * TS * TS * (c + 6) + t)
    valid, live = tiles_pairs(ti, nchunks)
    return bound(nbytes, 23 * valid + (11 + 2 * (c + 3)) * live)


def composite_tiles_bwd_bound(ti, nchunks):
    """Bytes: the rows of the slots the forward walked read once (the id
    and the gathered row of each) and their Dp-float gradient rows written
    once, the cotangents, starts, lens and nchunks read once.  Operations,
    counted on this run's data: the 23 of alpha and depth per (pixel, slot)
    pair inside a segment of those chunks, and 37 + 4(C + 3) more per pair
    whose alpha passes the cutoff (as for kernel 3, with V = C + 3
    values)."""
    t, c = ti.lens.shape[0], ti.n_color
    nbytes = (slot_read_bytes(ti, nchunks)
              + 4 * ti.per_gauss.shape[1] * walked_slots(ti, nchunks)
              + 4 * (t * TS * TS * (c + 6) + 3 * t + 1))
    valid, live = tiles_pairs(ti, nchunks)
    return bound(nbytes, 23 * valid + (37 + 4 * (c + 3)) * live)


def tiles_parity(name, scene):
    """Kernels 5 and 6 against their plain versions at the scene's shapes,
    at C = 3 and 16 and stop_threshold 0 and 1e-4 (the backward on the
    1e-4 forward's nchunks).  Returns the C = 3 inputs, the max abs errors
    and the early exits at 1e-4."""
    params, alive, cams, cfg = scene
    ti3, ti16 = tiles_inputs(params, alive, cams[0], cfg)
    errs = {"composite_tiles": 0.0, "composite_tiles_bwd": 0.0}
    early = {}
    for ti in (ti3.with_sink(4), ti16.with_sink(5)):
        for stop in (0.0, 1e-4):
            err, nch, n_early = check_tiles_fwd(ti, stop)
            errs["composite_tiles"] = max(errs["composite_tiles"], err)
            if stop == 0.0 and n_early:
                raise AssertionError(f"composite_tiles {name}: {n_early} "
                                     "tiles ended early at stop 0")
        early[ti.n_color] = n_early
        errs["composite_tiles_bwd"] = max(
            errs["composite_tiles_bwd"],
            check_tiles_bwd(ti.bwd_args(nch, 3), name))
    say(f"parity {name}: composite_tiles max abs err "
        f"{errs['composite_tiles']:.3g} (maps; nchunks equal, alpha and "
        f"median bit-identical) at C=3 and 16, stop 0 and 1e-4, rows through "
        f"the ids with a nonzero sink; tiles ending early at 1e-4: "
        f"{early[3]} (C=3), {early[16]} (C=16) of {ti3.lens.shape[0]}; "
        f"composite_tiles_bwd max abs err "
        f"{errs['composite_tiles_bwd']:.3g} (gradient tolerance per column "
        f"group, repeat bit-identical); max_chunks {ti3.max_chunks}, "
        f"M={ti3.ids.shape[0]}")
    return ti3, errs, early[3]


def check_edge_cases(dev):
    """Kernels 2, 3, 5 and 6 against their plain versions on the seeded
    edge cases of ``data/compositing_cases.py`` (the CPU tests hold the
    plain versions against the JAX package on the same inputs): kernel 2's
    maps, median slot and banked prefix and kernel 3 at V = 6 and 19;
    kernel 5 at C = 3 and 16 and stop 0 and 1e-4, kernel 6 on each of
    those forwards' nchunks and on one chunk fewer, both reading the
    cases' packed columns as rows through shuffled ids (no sink: the tie
    is searched at the splats' own positions).  The tied weights are
    searched on the card, so the tie holds in the kernels' arithmetic.
    Returns the max abs errors."""
    errs = dict.fromkeys(("composite", "composite_bwd", "composite_tiles",
                          "composite_tiles_bwd"), 0.0)
    tx, ty = compositing_cases.TIE_PIXEL
    tie_pix = ty * TS + tx
    for v in (6, 19):
        e = compositing_cases.edge_cases(v, dev)
        err, fwd = check_composite(e.g, e.mask, e.ntx)
        if int(fwd[4][compositing_cases.TIE_TILES[0], tie_pix]) != \
                compositing_cases.TIE_SLOTS[0]:
            raise AssertionError("composite: the tie pixel did not keep the "
                                 "first of its tied slots")
        errs["composite"] = max(errs["composite"], err)
        errs["composite_bwd"] = max(errs["composite_bwd"], check_composite_bwd(
            e.g, e.mask, e.ntx, fwd, 4, "edge cases"))
        ti = TilesInputs.of_matrix(e.isect, e.starts, e.lens, e.ntx, v - 3,
                                   e.max_chunks, seed=v)
        for stop in (0.0, 1e-4):
            err, nch, _ = check_tiles_fwd(ti, stop)
            errs["composite_tiles"] = max(errs["composite_tiles"], err)
            for n in (nch, torch.clamp(nch - 1, min=0)):
                errs["composite_tiles_bwd"] = max(
                    errs["composite_tiles_bwd"],
                    check_tiles_bwd(ti.bwd_args(n, 5), "edge cases"))
    say("parity edge cases (tied weights, segments of 1-129 slots, a dead "
        "batch, an early exit, masked slots between live ones): "
        + ", ".join(f"{k} max abs err {v:.3g}" for k, v in errs.items())
        + "; median slots and banked prefixes bit-identical")
    return errs


def check_pallas_vs_xla(name, scene):
    """The ``backend="pallas"`` render against the ``"xla"`` render of the
    scene's first camera: at stop_threshold 0 every map within the JAX
    package's own tolerance between the two (tests/test_pallas.py:42-43:
    atol 2e-6, depth 1e-4), at 1e-4 colour and alpha within 2e-4
    (:59-64)."""
    params, alive, cams, cfg = scene
    args = (params["means"], params["quats"],
            gaussians.activated_scales(params),
            gaussians.activated_opacity(params, alive),
            rade_gs.compute_colors(params, cams[0], 0, cfg), cams[0])
    ref, _ = rasterize.render_tiled(*args, cfg.render, alive_mask=alive)
    errs = {}
    for stop, maps in ((0.0, {"color": 2e-6, "alpha": 2e-6, "normal": 2e-6,
                               "median_depth": 2e-6, "depth": 1e-4}),
                       (1e-4, {"color": 2e-4, "alpha": 2e-4})):
        got, _ = rasterize.render_tiled_pallas(
            *args, dataclasses.replace(cfg.render, stop_threshold=stop),
            alive_mask=alive)
        for k, atol in maps.items():
            a, b = getattr(got, k), getattr(ref, k)
            errs[(stop, k)] = float((a - b).abs().max())
            torch.testing.assert_close(
                a, b, rtol=1e-7, atol=atol,
                msg=f"{name}: pallas vs xla {k} at stop {stop}")
    say(f"pallas vs xla render {name}: max abs err at stop 0 "
        + ", ".join(f"{k} {v:.3g}" for (s, k), v in errs.items() if s == 0)
        + "; at stop 1e-4 "
        + ", ".join(f"{k} {v:.3g}" for (s, k), v in errs.items() if s > 0))


def projector(params, alive, cam, opts):
    """The render's projection layer as a function of nothing, and the
    activated opacities it takes."""
    opac = gaussians.activated_opacity(params, alive)
    scales = gaussians.activated_scales(params)
    viewmat = cam.viewmat()

    def project():
        proj = project_gaussians(
            params["means"], params["quats"], scales, viewmat, cam.K,
            cam.width, cam.height, eps2d=opts.eps2d,
            near_plane=opts.near_plane, far_plane=opts.far_plane,
            radius_clip=opts.radius_clip, opacities=opac)
        return proj._replace(valid=proj.valid & alive)

    return project, opac


def layer_times(params, alive, cam, cfg, step=0):
    """Median ms of each layer of one render at ``step``, called in the
    order ``ops/rasterize.py::render_tiled`` calls them."""
    opts = cfg.render
    project, opac = projector(params, alive, cam, opts)
    proj = project()
    op = opac * proj.compensation
    colors = rade_gs.compute_colors(params, cam, step, cfg)
    plan = tiles.plan_bins(proj, cam.width, cam.height, opts, op)
    key, gid = binning_kernel.decode_bin_keys(*decode_args(plan))
    sorted_key, order = torch.sort(key, stable=True)
    sorted_gid = gid[order]

    def windows():
        return tiles._windows_from_sorted(
            sorted_key, sorted_gid, plan.ntx * plan.nty, plan.rank_bits,
            plan.ntx, plan.nty, plan.k_cap, plan.m_cap, plan.dropped)

    bins = windows()
    per_gauss = rasterize.pack_per_gauss(proj, op, proj.normal, colors)
    g = rasterize.window_rows(bins, per_gauss)
    mask = bins.tile_mask.to(torch.float32)
    return {
        "colors": median_ms(
            lambda: rade_gs.compute_colors(params, cam, step, cfg)),
        "projection": median_ms(project),
        "bin plan": median_ms(
            lambda: tiles.plan_bins(proj, cam.width, cam.height, opts, op)),
        "decode": median_ms(
            lambda: binning_kernel.decode_bin_keys(*decode_args(plan))),
        "sort": median_ms(lambda: torch.sort(key, stable=True)[1]),
        "windows": median_ms(windows),
        "gather": median_ms(lambda: rasterize.window_rows(
            bins, rasterize.pack_per_gauss(proj, op, proj.normal, colors))),
        "composite": median_ms(lambda: batched.composite_batched_fwd(
            g, mask, plan.ntx, TS, NEAR)),
    }


def pallas_layer_times(params, alive, cam, cfg, step=0):
    """Median ms of each layer of one ``backend="pallas"`` render at
    ``step``, called in the order ``ops/rasterize.py::render_tiled_pallas``
    calls them."""
    opts = cfg.render
    project, opac = projector(params, alive, cam, opts)
    proj = project()
    op = opac * proj.compensation
    colors = rade_gs.compute_colors(params, cam, step, cfg)

    def binning():
        return tiles.bin_gaussians(proj, cam.width, cam.height, opts, op)

    bins = binning()

    def align():
        return tiles.align_segments(bins.starts, bins.sorted_gid,
                                    composite.CHUNK)

    gid, starts, lens, _ = align()
    per_gauss = rasterize.pad_per_gauss(
        rasterize.pack_per_gauss(proj, op, proj.normal, colors))
    k_cap = opts.tile_capacity or tiles.default_tile_capacity(
        alive.shape[0])
    args = (per_gauss, gid, starts, lens, bins.num_tiles_x, TS,
            colors.shape[1], NEAR, opts.stop_threshold,
            -(-k_cap // composite.CHUNK))
    return {
        "colors": median_ms(
            lambda: rade_gs.compute_colors(params, cam, step, cfg)),
        "projection": median_ms(project),
        "binning (plan, decode, sort, windows)": median_ms(binning),
        "align segments": median_ms(align),
        "composite_tiles": median_ms(
            lambda: composite.composite_tiles_fwd(*args)),
    }


def check_outputs(name, out, cam):
    for k in KEYS:
        x = out[k]
        if x.shape[:2] != (cam.height, cam.width):
            raise AssertionError(f"{name}: {k} has shape {tuple(x.shape)}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: {k} is not finite")
    acc = out["accumulation"]
    if float(acc.min()) < 0.0 or float(acc.max()) > 1.0:
        raise AssertionError(f"{name}: accumulation outside [0, 1]")
    if not float(acc.max()) > 0.0:
        raise AssertionError(f"{name}: nothing was rendered")


def reference_check(dev, backend="xla", max_intersections=None):
    """The whole render on the card (kernels) against the same small scene
    rendered on the CPU (plain versions), within rtol/atol 1e-5."""
    params, alive, cams, cfg = make_scene("flagship", dev, n=3000,
                                          width=128, height=96)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, backend=backend, max_intersections=max_intersections))
    cam = cams[0]
    got, _ = render(params, alive, cam, cfg)
    cpu_cam = dataclasses.replace(cam, K=cam.K.cpu(), c2w=cam.c2w.cpu())
    ref, _ = render({k: v.cpu() for k, v in params.items()}, alive.cpu(),
                    cpu_cam, cfg)
    for k in KEYS:
        torch.testing.assert_close(got[k].cpu(), ref[k],
                                   msg=f"card vs CPU {k}", **TOL)
    err = max(float((got[k].cpu() - ref[k]).abs().max()) for k in KEYS)
    say(f"reference ({backend}): 3000 Gaussians at 128x96, "
        f"{max_intersections or 'default'} intersection slots, card "
        f"(kernels) vs CPU (plain versions): max abs err {err:.3g}")


def sink_shape(cam, n, opts):
    """The screen-space sink's shape for the render options' backend."""
    shape = rasterize.pallas_sink_shape if opts.backend == "pallas" \
        else rasterize.absgrad_sink_shape
    return shape(cam.width, cam.height, n, opts)


def train_reference_check(dev, backend="xla"):
    """One train step's loss and gradients on the card (kernels) against
    the same step on the CPU (plain versions), within the gradient
    tolerance: 3000 Gaussians at 128x96, sh_degree 3 with every band live,
    the depth-normal loss on."""
    params, alive, cams, _ = make_scene("flagship", dev, n=3000, width=128,
                                        height=96, sh_degree=3)
    cfg = rade_gs.RadeGSConfig(
        sh_degree=3, sh_degree_interval=1, background="black",
        render=RenderOptions(rasterize_mode="antialiased", backend=backend))
    image = torch.rand((96, 128, 3),
                       generator=torch.Generator().manual_seed(4))

    def step(device):
        cam = dataclasses.replace(cams[0], K=cams[0].K.to(device),
                                  c2w=cams[0].c2w.to(device))
        p = {k: v.detach().to(device).requires_grad_(True)
             for k, v in params.items()}
        al = alive.to(device)
        sink = torch.zeros(sink_shape(cam, al.shape[0], cfg.render),
                           device=device, requires_grad=True)
        out, _ = rade_gs.get_outputs(p, al, cam, 3, cfg, training=True,
                                     compute_error_maps=True,
                                     absgrad_sink=sink)
        loss, _ = rade_gs.get_loss(out, image.to(device), p, al, 3, cfg,
                                   reg_active=True)
        grads = torch.autograd.grad(loss, list(p.values()) + [sink])
        return loss.detach().cpu(), [x.cpu() for x in grads]

    (loss, grads), (ref_loss, ref_grads) = step(dev), step("cpu")
    torch.testing.assert_close(loss, ref_loss, **TOL)
    err = max(assert_grad_close(a, b, f"card vs CPU gradient {name}")
              for a, b, name in zip(grads, ref_grads,
                                    list(params) + ["sink"]))
    say(f"reference ({backend}): one train step, 3000 Gaussians at 128x96, "
        f"card "
        f"(kernels) vs CPU (plain versions): loss {float(loss):.6f} vs "
        f"{float(ref_loss):.6f}, gradients of {len(grads)} tensors within "
        f"the gradient tolerance (max abs err {err:.3g})")


def training_setup(dev, backend="xla", refine_every=REFINE_EVERY,
                   reg_from=REG_FROM):
    """A trainer on the bench scene at full width with the given
    compositor: the ground truth is the bench scene with sh_degree 3 (every
    band live from step 3), its renders on four orbit cameras are the
    images, and training starts from a perturbed copy (means, colours; 5%
    of the rows five times larger and 5% faint, so that the refine pass
    splits and culls)."""
    params, alive, cams, cfg = make_scene("bench", dev, sh_degree=3)
    model = rade_gs.RadeGSConfig(
        sh_degree=3, sh_degree_interval=1, background="random",
        render=dataclasses.replace(cfg.render, backend=backend),
        regularization_from_iter=reg_from)
    with torch.no_grad():
        images = [rade_gs.get_outputs(params, alive, c, 3, model,
                                      training=False)[0]["rgb"]
                  for c in cams]
    init, alive = perturbed_init(params, dev)
    conf = TrainerConfig(
        model=model, max_iterations=1000, seed=0,
        strategy=strategy.StrategyConfig(warmup_length=4,
                                         refine_every=refine_every))
    return Trainer(conf, cams, images, init, alive, device=dev)


def perturbed_init(params, dev):
    """The training start of the bench training scene: a perturbed copy of
    the ground truth ``params`` (means, colours; 5% of the rows five times
    larger and 5% faint), padded to 2^18 rows more, and its alive mask."""
    n = params["means"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    init = dict(params)
    init["means"] = params["means"] + 0.002 * torch.randn(
        (n, 3), generator=gen, device=dev)
    init["features_dc"] = params["features_dc"] + 0.3 * torch.randn(
        (n, 3), generator=gen, device=dev)
    pick = torch.rand((n, 1), generator=gen, device=dev)
    init["scales"] = torch.where(pick < 0.05, params["scales"] + math.log(5),
                                 params["scales"])
    init["opacities"] = torch.where(
        pick > 0.95, torch.full_like(params["opacities"],
                                     math.log(0.05 / 0.95)),
        params["opacities"])
    cap = n + (1 << 18)
    return (gaussians.pad_to_capacity(init, cap),
            torch.arange(cap, device=dev) < n)


# ------------------------------------------------- rade-features training
# The feature extractors' widths (CLIP ViT 768, DINOv2 384) at the feature
# datamanager's 64-pixel long edge of a 1280x720 capture.
FEATURE_DIMS = (("clip-vit", (768, 36, 64)), ("dinov2", (384, 36, 64)))
SAVE_AT = 12         # path 5 saves here; the resumed run crosses the refine
PROG_STEPS = 6       # progressive resolution: factors 4, 4, 2, 2, 1, 1
PROG_SCHEDULE = 2
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"


class FeatureData(NamedTuple):
    cams: list
    images: list
    feats: list      # per camera {branch: [C, 36, 64]}
    init: dict       # the training start, zero latents
    alive: torch.Tensor
    render: RenderOptions


def feature_data(dev, **scene):
    """The rade-features ground truth of the bench scene (sh_degree 0):
    each Gaussian carries 13 seeded latents; a camera's images are the
    scene's renders, its feature maps the rendered latents resized to
    36x64 and taken through a fixed seeded linear map per branch, so
    the decoder and the latents can learn them.  Training starts from the
    perturbed copy of the bench training scene with zero latents."""
    params, alive, cams, cfg = make_scene("bench", dev, **scene)
    n = alive.shape[0]
    gen = torch.Generator(device=dev).manual_seed(21)
    gt = dict(params, distill_features=torch.rand(
        (n, 13), generator=gen, device=dev))
    maps = {name: torch.randn((13, c), generator=gen, device=dev)
            / math.sqrt(13) for name, (c, _, _) in FEATURE_DIMS}
    model = rade_features.RadeFeaturesConfig(background="black",
                                             render=cfg.render)
    images, feats = [], []
    with torch.no_grad():
        for c in cams:
            out, _ = rade_gs.get_outputs(gt, alive, c, 0, model,
                                         training=False)
            images.append(out["rgb"])
            lat = decoder_lib.resize_bilinear(out["features"], (36, 64))
            feats.append({name: (lat @ m).permute(2, 0, 1).contiguous()
                          for name, m in maps.items()})
    init, train_alive = perturbed_init(params, dev)
    init["distill_features"] = torch.zeros(
        (train_alive.shape[0], 13), device=dev)
    return FeatureData(cams, images, feats, init, train_alive, cfg.render)


def feature_trainer(data, dev, backend="xla", refine_every=REFINE_EVERY,
                    reg_from=REG_FROM, checkpoint_fn=None,
                    feature_dims=FEATURE_DIMS, **trainer_kw):
    """A rade-features trainer as a user builds one:
    ``get_method("rade-features").make_trainer_config`` with its defaults
    (latent 13, hidden 64, sh_degree 0) at the bench scene's render options
    and ``num_downscales=0`` (or ``trainer_kw``), the method's groups, and
    a decoder drawn from a fixed seed."""
    spec = get_method("rade-features")
    base = spec.make_trainer_config(feature_dims=feature_dims,
                                    rasterize_mode="antialiased")
    model = dataclasses.replace(
        base.model, background="random", regularization_from_iter=reg_from,
        render=dataclasses.replace(data.render, backend=backend))
    conf = dataclasses.replace(base, **{
        "model": model, "max_iterations": 1000, "seed": 0,
        "num_downscales": 0, "steps_per_save": SAVE_AT,
        "strategy": strategy.StrategyConfig(warmup_length=4,
                                            refine_every=refine_every),
        **trainer_kw})
    decoder = decoder_lib.TwoLayerDecoder(
        model.latent_dim, model.mlp_hidden_dim, model.feature_dims_dict(),
        generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    return Trainer(conf, data.cams, data.images, data.init, data.alive,
                   groups=spec.groups, checkpoint_fn=checkpoint_fn,
                   features=data.feats, decoder=decoder, device=dev)


class Saver:
    """A ``checkpoint_fn`` that saves through ``Trainer.save`` and keeps
    each checkpoint's path and host seconds."""

    def __init__(self, directory):
        self.directory, self.paths, self.seconds = directory, [], []

    def __call__(self, tr):
        t0 = time.perf_counter()
        self.paths.append(tr.save(self.directory))
        self.seconds.append(time.perf_counter() - t0)


@torch.no_grad()
def check_step_kernels(kin, pallas, what, stop):
    """Every kernel of one train step against its plain version on the
    step's own inputs, captured by ``train_layer_times``: the decode
    (bit-exact); kernels 2 and 3 (``"xla"``) or 5 and 6 (``"pallas"``),
    each backward on the loss's cotangent; and kernel 4 on every segment
    sum of the backward and of the statistics, bit-identical.  Returns
    the max abs errors."""
    errs = {"decode": check_decode(None, kin["decode_args"])}
    if pallas:
        errs["composite_tiles_bwd"] = check_tiles_bwd(kin["bwd_args"], what)
        errs["composite_tiles"], nch, _ = check_tiles_fwd(kin["tiles"], stop)
        if not torch.equal(nch, kin["nchunks"]):
            raise AssertionError(f"{what}: composite_tiles nchunks differ "
                                 "from the step's")
        ti = kin["tiles"]
        width = f"C={ti.n_color} (Dp={ti.per_gauss.shape[1]})"
    else:
        g, mask, ntx = kin["fwd_args"][:3]
        errs["composite"], _ = check_composite(g, mask, ntx)
        errs["composite_bwd"] = check_composite_bwd_args(kin["bwd_args"],
                                                         what)
        width = f"V={g.shape[2] - 9}"
    dims = []
    for args in kin["step_segsum_args"]:
        check_segsum_rows(*args, f"{what} D={args[2].shape[1]}")
        dims.append(int(args[2].shape[1]))
    errs["segment_sum"] = 0.0
    say(f"parity {what} (step inputs, {width}): decode bit-exact; "
        + ", ".join(f"{k} max abs err {v:.3g}" for k, v in errs.items()
                    if k not in ("decode", "segment_sum"))
        + f"; segment_sum bit-identical at D={dims} (M="
        f"{[int(a[2].shape[0]) for a in kin['step_segsum_args']]}), repeats "
        f"bit-identical")
    return errs


def check_features_falling(hist, what):
    """The feature loss of the path's last four steps below that of its
    first four (the camera changes from step to step)."""
    f = [h["features_loss"] for h in hist]
    first, last = statistics.mean(f[:4]), statistics.mean(f[-4:])
    say(f"{what}: features_loss " + ", ".join(f"{x:.6f}" for x in f)
        + f"; mean of the first four {first:.6f}, of the last four "
        f"{last:.6f}")
    if not last < first:
        raise AssertionError(f"{what}: features_loss did not fall")


def same_state(a, b):
    """The names of what differs between two ``Trainer.state()``s, bit for
    bit: parameters, decoder, alive mask, statistics, step, Adam state and
    rates."""
    bad = [f"param {k}" for k in a["params"]
           if not torch.equal(a["params"][k], b["params"][k])]
    bad += [f"decoder {k}" for k in (a["decoder"] or {})
            if not torch.equal(a["decoder"][k], b["decoder"][k])]
    if not torch.equal(a["alive"], b["alive"]):
        bad.append("alive")
    bad += [f"statistic {k}" for k, x, y in zip(
        strategy.StrategyState._fields, a["strat_state"], b["strat_state"])
        if not torch.equal(x, y)]
    if a["step"] != b["step"]:
        bad.append("step")
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    if sa.keys() != sb.keys():
        bad.append("Adam state keys")
    else:
        bad += [f"Adam {i} {k}" for i in sa for k in sa[i]
                if not torch.equal(sa[i][k], sb[i][k])]
    if [g["lr"] for g in a["optimizer"]["param_groups"]] != \
            [g["lr"] for g in b["optimizer"]["param_groups"]]:
        bad.append("rates")
    return bad


def kill_and_resume(data, dev, path, final, steps, refine_at):
    """A fresh trainer restores the checkpoint at ``path`` (path 5's save
    at step SAVE_AT) and trains to ``steps``, across the refine pass; its
    state must be the bits of ``final``, path 5's state at that step."""
    tr = feature_trainer(data, dev)
    t0 = time.perf_counter()
    tr.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if tr.step != SAVE_AT:
        raise AssertionError(f"restore: step {tr.step}, expected {SAVE_AT}")
    hist, _, _ = train_main_path(tr, steps - SAVE_AT, refine_at)
    bad = same_state(tr.state(), final)
    if bad:
        raise AssertionError(f"kill and resume: differs from the run that "
                             f"was not killed in {bad}")
    r = hist[refine_at - SAVE_AT - 1]
    say(f"kill and resume: a fresh trainer restored {path.name} in "
        f"{restore_s:.2f} s and trained steps {SAVE_AT + 1}-{steps} (the "
        f"refine after step {refine_at}: dup {r['refine_dup']}, split "
        f"{r['refine_split']}, capacity {tr.alive.shape[0]}): parameters "
        f"({len(final['params'])} tensors), decoder, alive mask, Adam state, "
        f"rates, statistics and step bit-identical to the run that was not "
        f"killed")
    del tr


def progressive_phase(data, dev):
    """PROG_STEPS steps at num_downscales=2 and resolution_schedule
    PROG_SCHEDULE (factors 4, 4, 2, 2, 1, 1): each step's camera and
    box-filtered ground truth at 1/factor of 1280x720, and each kernel's
    launches in each step, with the counts at 0 just before it."""
    tr = feature_trainer(data, dev, refine_every=10 ** 6, reg_from=0,
                         num_downscales=2,
                         resolution_schedule=PROG_SCHEDULE)
    full = tr.cameras[0]
    per_step = {"decode": 1, "composite": 1, "composite_bwd": 1,
                "segment_sum": 2}
    total = dict.fromkeys(counts(), 0)
    rows, factors = [], []
    for _ in range(PROG_STEPS):
        d = tr.downscale_factor()
        factors.append(d)
        reset_counts()
        with captured(rade_features, "get_loss") as seen:
            m = tr.train_one_step()
        torch.cuda.synchronize()
        launches = counts()
        if launches != {k: per_step.get(k, 0) for k in launches}:
            raise AssertionError(f"progressive factor {d}: launches "
                                 f"{launches}")
        outputs, image = seen[0][0], seen[0][1]
        want = (full.height // d, full.width // d)
        cam = full.downscaled(d)
        if (cam.height, cam.width) != want or \
                tuple(outputs["rgb"].shape[:2]) != want or \
                tuple(image.shape) != want + (3,):
            raise AssertionError(f"progressive factor {d}: camera "
                                 f"{cam.width}x{cam.height}, render "
                                 f"{tuple(outputs['rgb'].shape)}, ground "
                                 f"truth {tuple(image.shape)}")
        if not math.isfinite(m["loss"]) or m["nonfinite_grad"]:
            raise AssertionError(f"progressive factor {d}: {m}")
        total = {k: total[k] + v for k, v in launches.items()}
        rows.append(f"factor {d}: {want[1]}x{want[0]}, ground truth "
                    f"{tuple(image.shape)}, launches "
                    f"{ {k: v for k, v in launches.items() if v} }")
    if factors != [4, 4, 2, 2, 1, 1]:
        raise AssertionError(f"progressive factors {factors}")
    say(f"progressive resolution (num_downscales=2, resolution_schedule="
        f"{PROG_SCHEDULE}): " + "; ".join(rows))
    ev = tr.eval_image(full, data.images[0])
    say(f"progressive resolution: evaluation at full resolution "
        f"{full.width}x{full.height}, PSNR {ev['psnr']:.2f} dB")
    del tr
    return total




def counts():
    return {"decode": binning_kernel.launches, "composite": batched.launches,
            "composite_bwd": batched.bwd_launches,
            "segment_sum": segsum_kernel.launches,
            "composite_tiles": composite.launches,
            "composite_tiles_bwd": composite.bwd_launches}


def reset_counts():
    binning_kernel.launches = segsum_kernel.launches = 0
    batched.launches = batched.bwd_launches = 0
    composite.launches = composite.bwd_launches = 0


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (a check against a plain version, a timing
    repeat) leave every count as it was before the block."""
    saved = counts()
    try:
        yield
    finally:
        binning_kernel.launches = saved["decode"]
        batched.launches = saved["composite"]
        batched.bwd_launches = saved["composite_bwd"]
        segsum_kernel.launches = saved["segment_sum"]
        composite.launches = saved["composite_tiles"]
        composite.bwd_launches = saved["composite_tiles_bwd"]


def train_main_path(tr, steps, refine_at):
    """A training main path: ``steps`` steps through ``Trainer.train``
    with every launch count at 0 just before and read just after; the
    opacity reset after step refine_every, the refine pass after step
    ``refine_at``.  Returns (history, host ms per step, launches)."""
    scfg = tr.config.strategy
    reset_at = scfg.refine_every
    logit_cap = math.log(0.2 / 0.8)
    hist, ms = [], []
    reset_counts()
    for _ in range(steps):
        if tr.step == refine_at - 1:
            # The reference threshold is in the NDC units of real captures;
            # on this random scene the refine pass densifies the 1% of
            # rows with the largest mean gradient instead.
            st = tr.strat_state
            seen = tr.alive & (st.count > 0)
            avg = (st.grad_accum / torch.clamp(st.count, min=1.0))[seen]
            thresh = float(torch.quantile(avg, 0.99))
            tr.config = dataclasses.replace(tr.config, strategy=(
                dataclasses.replace(scfg, densify_grad_thresh=thresh)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(1, log_every=10 ** 9)   # runs checkpoint_fn, if any
        hist.append(tr.history[-1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if tr.step == reset_at:
            top = float(tr.params["opacities"].detach()[tr.alive].max())
            if top > logit_cap + 1e-6:
                raise AssertionError(f"opacity reset: max logit {top}")
    launches = counts()
    return hist, ms, launches


def check_training(hist, launches, refine_at, reg_from, per_step):
    """Finite losses, the depth-normal phase from ``reg_from``, the launch
    counts ``per_step`` times the steps, and a refine pass that duplicated,
    split and culled."""
    steps = len(hist)
    for i, h in enumerate(hist):
        if not math.isfinite(h["loss"]) or h["nonfinite_grad"] != 0:
            raise AssertionError(f"train step {i}: {h}")
        if ("depth_normal_loss" in h) != (i >= reg_from):
            raise AssertionError(f"train step {i}: depth-normal phase")
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{want} in {steps} steps")
    ref = hist[refine_at - 1]
    if not all(ref.get(k, 0) > 0 for k in ("refine_dup", "refine_split",
                                            "refine_cull")):
        raise AssertionError(f"refine pass: {ref}")


def check_determinism(tr):
    """One step run twice from the same state: the parameters, the Adam
    moments and the statistics must come out the same bits."""
    snap = tr.state()

    def run():
        tr.train_one_step()
        s = tr.state()
        moments = [v for st in s["optimizer"]["state"].values()
                   for k, v in sorted(st.items()) if k != "step"]
        return [*s["params"].values(), *s["camera_params"].values(),
                *(s["decoder"] or {}).values(), *s["strat_state"], *moments]

    a = run()
    tr.load_state(snap)
    b = run()
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    if not same:
        tr.load_state(snap)
        torch.use_deterministic_algorithms(True, warn_only=True)
        tr.train_one_step()
        torch.use_deterministic_algorithms(False)
        raise AssertionError("a repeated train step gave other bits (the "
                             "warnings above name the ops PyTorch knows "
                             "to be nondeterministic)")
    say(f"determinism: step {snap['step']} run twice from the same state "
        f"gave bit-identical parameters ({len(snap['params'])} tensors"
        + (f", per-camera {sorted(snap['camera_params'])}"
           if snap["camera_params"] else "")
        + "), Adam moments and statistics")


def refine_times(tr):
    """Host-clock ms of the refine pass alone on the trainer's state (its
    result is dropped): the dense capacity-wide work and the split noise
    drawn on the card."""
    scfg = tr.config.strategy

    def run():
        return strategy.refine(
            tr.params, tr.alive, tr.strat_state, scfg,
            generator=torch.Generator(device=tr.device).manual_seed(0),
            scene_scale=tr.config.scene_scale, screen_size_cull=True)

    return timings(run, host_clock=True)


def fitting_run(dev):
    """Fit the flagship scene from a perturbed copy (means jittered,
    colours reset, as tests/test_training.py does) for FIT_STEPS steps;
    PSNR on a training camera must rise by 3 dB."""
    params, alive, _, cfg = make_scene("flagship", dev)
    cams = synthetic.orbit_cameras(4, radius=3.0, width=512, height=512,
                                   focal=1.2 * 512, device=dev)
    model = dataclasses.replace(cfg, use_depth_normal_loss=False)
    with torch.no_grad():
        images = [rade_gs.get_outputs(params, alive, c, 0, model,
                                      training=False)[0]["rgb"]
                  for c in cams]
    gen = torch.Generator(device=dev).manual_seed(7)
    init = dict(params)
    init["means"] = params["means"] + 0.02 * torch.randn(
        params["means"].shape, generator=gen, device=dev)
    init["features_dc"] = torch.zeros_like(params["features_dc"])
    tr = Trainer(TrainerConfig(
        model=model, max_iterations=FIT_STEPS,
        strategy=strategy.StrategyConfig(warmup_length=10 ** 7)),
        cams, images, init, alive, device=dev)
    t0 = time.perf_counter()
    first = tr.train_one_step()
    for _ in range(FIT_STEPS - 1):
        last = tr.train_one_step()
    seconds = time.perf_counter() - t0
    ev = tr.eval_image(cams[0], images[0])
    say(f"fitting run: flagship scene (20,000 Gaussians, 512x512, 4 "
        f"cameras), {FIT_STEPS} steps in {seconds:.1f} s: PSNR "
        f"{first['psnr']:.2f} dB at the first step, {ev['psnr']:.2f} dB on "
        f"camera 0 after (SSIM {ev['ssim']:.4f}), last loss "
        f"{last['loss']:.5f}")
    if not ev["psnr"] > first["psnr"] + 3.0:
        raise AssertionError("fitting run: PSNR rose by less than 3 dB")


@contextlib.contextmanager
def captured(module, name, limit=None):
    """Collects the arguments of every call of ``module.name`` made inside
    the block (for a backward kernel under autograd: the step's own inputs
    and the loss's cotangent); with ``limit``, of the first ``limit``
    calls only."""
    seen, real = [], getattr(module, name)

    def call(*args, **kwargs):
        if limit is None or len(seen) < limit:
            seen.append(args)
        return real(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def train_layer_times(tr):
    """Card time of each layer of one train step on camera 0 (median of
    REPS CUDA-event timings), and the kernels' inputs at the step's
    shapes, for the trainer's compositor: the decode's and the compositing
    forward's arguments, the backward's (with the loss's cotangent), and
    every segment sum of the backward and of the statistics.  With
    features the loss is rade-features' and the decoder's tensors are
    leaves too."""
    cfg = tr.config.model
    pallas = cfg.render.backend == "pallas"
    feats = tr.features is not None
    params, alive, cam, image = tr.params, tr.alive, tr.cameras[0], \
        tr.images[0]
    dparams = list(tr.decoder.parameters()) if feats else []
    leaves = list(params.values()) + dparams
    sink = torch.zeros(sink_shape(cam, alive.shape[0], cfg.render),
                       device=cam.K.device, requires_grad=True)

    def forward():
        return rade_gs.get_outputs(
            params, alive, cam, tr.step, cfg,
            generator=torch.Generator().manual_seed(0), training=True,
            compute_error_maps=True, absgrad_sink=sink)

    fwd_module, fwd_name = ((composite, "composite_tiles_fwd") if pallas
                            else (batched, "composite_batched_fwd"))
    with captured(fwd_module, fwd_name) as fwd_seen, \
            captured(tiles, "decode_bin_keys") as decode_seen:
        outputs, meta = forward()

    def loss_fn():
        if feats:
            return rade_features.get_loss(
                outputs, image, tr.features[0], params, tr.decoder, alive,
                tr.step, cfg, reg_active=True)[0]
        return rade_gs.get_loss(outputs, image, params, alive, tr.step, cfg,
                                reg_active=True)[0]

    loss = loss_fn()
    bwd_module, bwd_name = ((composite, "composite_tiles_bwd_call") if pallas
                            else (batched, "composite_batched_bwd"))
    with captured(bwd_module, bwd_name) as seen, \
            captured(segsum, "segment_sum_sorted") as seg_seen:
        grads = torch.autograd.grad(loss, leaves + [sink], retain_graph=True,
                                    allow_unused=True)
    if len(seen) != 1:
        raise AssertionError(f"train step: {len(seen)} {bwd_name} calls in "
                             "a backward")
    # The compositing backward's own inputs in the step: its matrix or
    # window rows and the loss's cotangent.
    bargs = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                  for a in seen[0])
    out = {
        "forward (render, error maps)": median_ms(forward),
        **{f"forward: {k}": v for k, v in (
            pallas_layer_times if pallas else layer_times)(
                params, alive, cam, cfg, tr.step).items()},
    }
    if feats:
        out["decode and resize"] = median_ms(
            lambda: decoder_lib.decode_rendered_features(
                tr.decoder, outputs["features"], cfg.feature_dims_dict(),
                cfg.main_feature_name))
        out["feature loss (decode, resize, cosine)"] = median_ms(
            lambda: rade_features.feature_loss(outputs, tr.features[0],
                                               tr.decoder, cfg))
    out.update({
        "loss": median_ms(loss_fn),
        "backward (autograd.grad)": median_ms(lambda: torch.autograd.grad(
            loss, leaves + [sink], retain_graph=True, allow_unused=True)),
    })
    # The kernels of the backward, alone, on the step's inputs.
    n = alive.shape[0]
    bwd = "composite_tiles_bwd kernel" if pallas else "composite_bwd kernel"
    out[bwd] = median_ms(lambda: getattr(bwd_module, bwd_name)(*bargs))
    if pallas:
        ti = TilesInputs(*bargs[:5], bargs[8], bargs[10], bargs[11])
        idx = segsum.spread_masked(meta.aligned_gid, meta.aligned_valid, n)
        d = ti.per_gauss.shape[1]
        kernels = {"tiles": ti, "nchunks": bargs[5], "bwd_args": bargs}
        update = strategy.update_state_from_isect
    else:
        idx = window_idx(meta.bins, n)
        d = bargs[0].shape[2]
        kernels = {"g": bargs[0], "mask": bargs[1], "ntx": bargs[9],
                   "bwd_args": bargs}
        update = strategy.update_state
    sorted_ids, order, rows = segsum_inputs(idx, d, 7)
    out["segment-sum sort"] = median_ms(lambda: torch.sort(idx, stable=True))
    out["segment_sum kernel"] = median_ms(
        lambda: segsum_kernel.segment_sum_sorted(sorted_ids, order, rows, n))
    out["rest of the backward"] = (out["backward (autograd.grad)"] - out[bwd]
                                   - out["segment-sum sort"]
                                   - out["segment_sum kernel"])
    out[f"statistics ({update.__name__})"] = median_ms(
        lambda: update(tr.strat_state, meta, grads[-1]))
    with captured(segsum, "segment_sum_sorted") as stat_seen:
        update(tr.strat_state, meta, grads[-1])
    # The statistic's D = 2 rows: this backward's masked |sink gradient|,
    # on the same sorted ids.
    valid = meta.aligned_valid if pallas else meta.bins.tile_mask.reshape(-1)
    g2 = grads[-1].abs()
    g2 = g2.T if pallas else g2.reshape(-1, 2)
    rows2 = torch.where(valid[:, None], g2,
                        torch.zeros((), device=g2.device)).contiguous()
    kernels["segsum2_args"] = (sorted_ids, order, rows2, n)
    for p, gr in zip(leaves, grads):
        p.grad = gr
    out["Adam" + (" (with the decoder group)" if feats else "")] = median_ms(
        tr.optimizer.step)   # moves the parameters
    tr.optimizer.zero_grad(set_to_none=True)
    kernels.update(segsum_args=(sorted_ids, order, rows, n), idx=idx,
                   fwd_args=detached(fwd_seen[0]),
                   decode_args=detached(decode_seen[0]),
                   step_segsum_args=detached([*seg_seen, *stat_seen]))
    return out, kernels


def detached(x):
    """``x`` (tensors, named tuples, tuples and lists of them) with every
    tensor detached from the autograd graph."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(detached(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(detached(v) for v in x)
    return x


def feature_step_path(data, dev, backend):
    """Main path 5 (``"xla"``) or 6 (``"pallas"``): the rade-features
    trainer's layers and every kernel on a step's own inputs (on its first
    state, put back afterwards), then its steps with the depth-normal loss,
    one opacity reset and one refine pass, a falling feature loss and a
    bit-identical repeated step.  Path 5 saves at step SAVE_AT through
    ``checkpoint_fn`` and is killed and resumed from that save.  Returns
    the layer times, the kernels' step inputs and errors, and the
    launches."""
    pallas = backend == "pallas"
    steps, reg_from, every = ((PALLAS_STEPS, PALLAS_REG_FROM,
                               PALLAS_REFINE_EVERY) if pallas
                              else (TRAIN_STEPS, REG_FROM, REFINE_EVERY))
    refine_at = PALLAS_REFINE_AT if pallas else 2 * REFINE_EVERY
    saver = None if pallas else Saver(CKPT_DIR)
    if not pallas:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    tr = feature_trainer(data, dev, backend, every, reg_from,
                         checkpoint_fn=saver)
    start = tr.state()
    layers, kin = train_layer_times(tr)
    tr.load_state(start)
    del start
    what = f"rade-features {backend} step"
    errs = check_step_kernels(kin, pallas, what,
                              tr.config.model.render.stop_threshold)
    hist, step_ms, launches = train_main_path(tr, steps, refine_at)
    check_training(hist, launches, refine_at, reg_from, {
        "decode": 1, "segment_sum": 2,
        **({"composite_tiles": 1, "composite_tiles_bwd": 1} if pallas
           else {"composite": 1, "composite_bwd": 1})})
    path = 6 if pallas else 5
    say(f"main path {path} (rade-features training, {backend}): "
        f"{len(hist)} steps of the bench scene (1M Gaussians, 1280x720, "
        f"latent 13, clip-vit 768 and dinov2 384 at 64x36), launches "
        f"{launches}; losses " + ", ".join(f"{h['loss']:.5f}" for h in hist)
        + f"; PSNR {hist[0]['psnr']:.2f} -> {hist[-1]['psnr']:.2f} dB")
    r = hist[refine_at - 1]
    say(f"refine (rade-features, {backend}) after step {refine_at}: dup "
        f"{r['refine_dup']}, split {r['refine_split']}, cull "
        f"{r['refine_cull']}, dropped {r['refine_dropped']}; Gaussians "
        f"{r['num_gaussians']} -> {hist[-1]['num_gaussians']}, capacity "
        f"{tr.alive.shape[0]}; opacity reset after step {every}; "
        f"depth-normal loss from step {reg_from}")
    check_features_falling(hist, f"main path {path}")
    ckpt_steps = [] if pallas else [SAVE_AT - 1]
    other = [t for i, t in enumerate(step_ms) if i not in ckpt_steps]
    say(f"feature train step ({backend}, host clock, bench scene): median "
        f"{statistics.median(other):.4f} ms over {len(other)} steps "
        f"without a save, min {min(other):.4f}, max {max(other):.4f}"
        + ("" if pallas else
           f"; the step that saved took {step_ms[SAVE_AT - 1]:.4f} ms, the "
           f"save {1e3 * saver.seconds[0]:.1f} ms ({saver.paths[0].name}, "
           f"{saver.paths[0].stat().st_size / 2 ** 20:.1f} MiB)"))
    final = tr.state()
    check_determinism(tr)
    del tr
    torch.cuda.empty_cache()
    if not pallas:
        kill_and_resume(data, dev, saver.paths[0], final, steps, refine_at)
    del final
    torch.cuda.empty_cache()
    return {"layers": layers, "kin": kin, "errs": errs,
            "launches": launches, "ckpt": saver and saver.paths[0]}


def per_element(what, ms, elements):
    return f"{what} {ms:.4f} ms, {1e6 * ms / elements:.4f} ns per element"


# Main path 7, mesh extraction (meshing/exporters.py) from path 5's
# checkpoint.  The bench cameras orbit at radius 3.0, so the exporter's
# default depth_trunc of 1.0 would drop every depth: 6.0 keeps the scene.
MESH_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
MESH_DEPTH_TRUNC = 6.0
POISSON_RES = 256
LEVEL_SET_RES = 128      # the level-set extractor's default
FLAGSHIP_MESH_SIZE = 512
MESH_STAGES = ("render", "integrate", "to host", "marching", "clean repair",
               "transfer", "floor alignment", "write ply")
POISSON_STAGES = ("scatter", "fft solve", "to host", "marching", "colors")
TRANSFER_SAMPLE = 256   # vertices whose transfer is held against the CPU


def stage_line(times, names):
    """'name total s (per call ms, ...)' for each stage that ran."""
    out = []
    for k in names:
        if k in times:
            t = times[k]
            per = "" if len(t) == 1 else " (" + ", ".join(
                f"{1e3 * x:.4f}" for x in t) + " ms)"
            out.append(f"{k} {sum(t):.4f} s{per}")
    return "; ".join(out)


def check_mesh(res, what, latent=0):
    """At least one face, face indices in range, finite vertices, colours
    in [0, 1], normals of length at most 1 (each an inverse-distance
    average of unit normals), features [V, latent]."""
    v, f = res["vertices"], res["faces"]
    n = len(v)
    if len(f) == 0 or not np.isfinite(v).all():
        raise AssertionError(f"{what}: {len(f)} faces, finite vertices "
                             f"{bool(np.isfinite(v).all())}")
    if f.min() < 0 or f.max() >= n:
        raise AssertionError(f"{what}: face indices outside [0, {n})")
    widths = {"colors": 3, "normals": 3, **({"features": latent}
                                            if latent else {})}
    for key, width in widths.items():
        x = res.get(key)
        if x is None or x.shape != (n, width) or not np.isfinite(x).all():
            raise AssertionError(f"{what}: {key} is not finite [{n}, "
                                 f"{width}]")
    c = res["colors"]
    if c.min() < 0.0 or c.max() > 1.0:
        raise AssertionError(f"{what}: colours outside [0, 1]")
    lengths = np.linalg.norm(res["normals"], axis=-1)
    if lengths.max() > 1.0 + 1e-4:
        raise AssertionError(f"{what}: a normal of length {lengths.max()}")
    return lengths


def hold_volumes(got, ref, sdf_trunc, what, depth_max):
    """A TSDF volume on the card against the same export on the CPU:
    weights equal, tsdf within the render's tolerance carried through
    (1e-5 + 1e-5 * depth) / sdf_trunc, colours and features within 1e-5,
    except at voxels whose decision flipped (at most 1e-4 of them)."""
    w_got, w_ref = got.weight.cpu(), ref.weight
    differ = w_got != w_ref
    tol = {"tsdf": (1e-5 + 1e-5 * depth_max) / sdf_trunc, "color": 1e-5,
           "features": 1e-5}
    errs = {}
    for name, t in tol.items():
        a, b = getattr(got, name), getattr(ref, name)
        if a is None and b is None:
            continue
        err = (a.cpu() - b).abs().reshape(differ.numel(), -1).amax(-1)
        err = err.reshape(differ.shape)
        errs[name] = float(err[~differ].max()) if (~differ).any() else 0.0
        differ |= err > t
    n_diff = int(differ.sum())
    if n_diff > 1e-4 * differ.numel() or not bool((w_ref > 0).any()):
        raise AssertionError(f"{what}: {n_diff} of {differ.numel()} voxels "
                             f"differ from the CPU's (errors {errs})")
    return n_diff, errs


def hold_meshes(got, ref, voxel, what, attrs=()):
    """A mesh from the card against the CPU's: vertex counts within 2%,
    symmetric mean Chamfer distance at most 0.25 voxel, each attribute in
    ``attrs`` within 1e-4 at matched vertices (mutual nearest, closer than
    1e-3 voxel)."""
    gv = np.asarray(got["vertices"], np.float64)
    rv = np.asarray(ref["vertices"], np.float64)
    if abs(len(gv) - len(rv)) > 0.02 * len(rv) or len(rv) == 0:
        raise AssertionError(f"{what}: {len(gv)} vertices on the card, "
                             f"{len(rv)} on the CPU")
    d_gr, i_gr = cKDTree(rv).query(gv)
    d_rg, i_rg = cKDTree(gv).query(rv)
    chamfer = 0.5 * (d_gr.mean() + d_rg.mean()) / voxel
    matched = (i_rg[i_gr] == np.arange(len(gv))) & (d_gr < 1e-3 * voxel)
    errs = {k: float(np.abs(got[k][matched] - ref[k][i_gr[matched]]).max())
            for k in attrs}
    if chamfer > 0.25 or matched.mean() < 0.5 or any(
            e > 1e-4 for e in errs.values()):
        raise AssertionError(f"{what}: Chamfer {chamfer:.3g} voxel, "
                             f"{100 * matched.mean():.1f}% matched, "
                             f"attribute errors {errs}")
    return chamfer, float(matched.mean()), errs


def on_cpu(params, alive, cams):
    return ({k: v.cpu() for k, v in params.items()}, alive.cpu(),
            [dataclasses.replace(c, K=c.K.cpu(), c2w=c.c2w.cpu())
             for c in cams])


def mesh_small_scenes(dev, scenes):
    """The meshing paths on small scenes, on the card against the CPU
    (plain versions): the TSDF exporter on the flat disk of
    tests/test_meshing.py (volumes and mesh), the level-set extractor
    (density grid and mesh) and the depth-and-normal Poisson exporter
    (mesh) on the flagship scene; then both on the flagship scene at their
    full sizes on the card alone, timed."""
    disk = synthetic.flat_disk_gaussian(normal=(0, 0, 1), radius=0.5,
                                        thickness=0.005, device=dev)
    disk["opacities"] = torch.full((1, 1), 8.0, device=dev)
    cams = synthetic.orbit_cameras(6, radius=2.0, width=64, height=64,
                                   focal=80.0, elevation=0.9, device=dev)
    mcfg = rade_gs.RadeGSConfig(sh_degree=0, background="black",
                                render=RenderOptions(
                                    tile_capacity=64,
                                    max_intersections=1 << 12))
    ecfg = exporters.TSDFExporterConfig(
        voxel_size=0.04, sdf_trunc=0.12, depth_trunc=4.0, align_floor=False,
        max_dim=64, clean_repair=True)
    alive = torch.ones(1, dtype=torch.bool, device=dev)
    card = exporters.TSDFFusionExporter(disk, alive, mcfg, ecfg)
    got = card.main(cams)
    cdisk, calive, ccams = on_cpu(disk, alive, cams)
    cpu = exporters.TSDFFusionExporter(cdisk, calive, mcfg, ecfg)
    ref = cpu.main(ccams)
    for r, w in ((got, "card"), (ref, "CPU")):
        # One Gaussian: every vertex normal is its unit normal.
        lengths = check_mesh(r, f"disk TSDF ({w})")
        if np.abs(lengths - 1.0).max() > 1e-4:
            raise AssertionError(f"disk TSDF ({w}): normals not unit")
    n_diff, verrs = hold_volumes(card.volume, cpu.volume,
                                 card.tsdf_config.sdf_trunc, "disk TSDF", 4.0)
    chamfer, share, merrs = hold_meshes(got, ref, card.tsdf_config.voxel_size,
                                        "disk TSDF mesh",
                                        ("colors", "normals"))
    say(f"meshing, card vs CPU: TSDF exporter on the flat disk (6 cameras "
        f"at 64x64, dims {card.tsdf_config.dims}): {n_diff} voxels with "
        f"another decision, otherwise max abs err {verrs}; mesh "
        f"{len(got['vertices'])}/{len(ref['vertices'])} vertices, Chamfer "
        f"{chamfer:.3g} voxel, {100 * share:.1f}% matched, attribute errors "
        f"{merrs}")

    params, alive, _, cfg = scenes["flagship"]
    size = FLAGSHIP_MESH_SIZE
    cams = synthetic.orbit_cameras(2, radius=3.0, width=size, height=size,
                                   focal=1.2 * size, device=dev)
    cparams, calive, ccams = on_cpu(params, alive, cams)
    pts = params["means"]
    lo = pts.min(0).values.cpu().numpy() - 0.1
    hi = pts.max(0).values.cpu().numpy() + 0.1
    dens = exporters.gaussian_density_grid(params, alive, lo, hi, 32)[0]
    dref = exporters.gaussian_density_grid(cparams, calive, lo, hi, 32)[0]
    derr = float(np.abs(dens - dref).max())
    if derr > 1e-5 * float(np.abs(dref).max()):
        raise AssertionError(f"density grid: card vs CPU max abs err {derr}")
    got = exporters.LevelSetExtractor(params, alive, cfg,
                                      resolution=32).main()
    ref = exporters.LevelSetExtractor(cparams, calive, cfg,
                                      resolution=32).main()
    voxel = float(((hi - lo) / 31).max())
    ls = hold_meshes(got, ref, voxel, "flagship level set")
    ls_counts = (len(got["vertices"]), len(ref["vertices"]))
    dn = exporters.DepthAndNormalMapsPoissonExporter(params, alive, cfg,
                                                     grid_res=128)
    got = dn.main(cams)
    ref = exporters.DepthAndNormalMapsPoissonExporter(
        cparams, calive, cfg, grid_res=128).main(ccams)
    npts = (len(got["points"]), len(ref["points"]))
    if abs(npts[0] - npts[1]) > 1e-3 * npts[1]:
        raise AssertionError(f"depth-normal points: {npts}")
    span = float((ref["points"].max(0) - ref["points"].min(0)).max())
    pn = hold_meshes(got, ref, 1.2 * span / 127,
                     "flagship depth-normal Poisson")
    say(f"meshing, card vs CPU, flagship scene ({pts.shape[0]} "
        f"Gaussians): density grid 32^3 max abs err {derr:.3g} (max "
        f"{float(dref.max()):.4f}); "
        f"level set (32^3) mesh {ls_counts[0]}/{ls_counts[1]} vertices, "
        f"Chamfer {ls[0]:.3g} voxel, {100 * ls[1]:.1f}% matched; "
        f"depth-normal Poisson (2 cameras at {size}x{size}, grid 128): "
        f"{npts[0]}/{npts[1]} points, mesh {len(got['vertices'])}/"
        f"{len(ref['vertices'])} vertices, Chamfer {pn[0]:.3g} voxel, "
        f"{100 * pn[1]:.1f}% matched")

    # Full sizes on the card: the level set at 128^3, the depth-normal
    # Poisson over four cameras at grid 256.
    times = {}
    t0 = time.perf_counter()
    res = exporters.LevelSetExtractor(
        params, alive, cfg, resolution=LEVEL_SET_RES).main(stage_times=times)
    whole = time.perf_counter() - t0
    say(f"meshing layers, flagship level set ({LEVEL_SET_RES}^3, host "
        f"clock): "
        f"{stage_line(times, ('density grid', 'marching', 'transfer'))}; "
        f"whole {whole:.4f} s; {len(res['vertices'])} vertices, "
        f"{len(res['faces'])} faces")
    cams = synthetic.orbit_cameras(4, radius=3.0, width=size, height=size,
                                   focal=1.2 * size, device=dev)
    times = {}
    t0 = time.perf_counter()
    res = exporters.DepthAndNormalMapsPoissonExporter(
        params, alive, cfg, grid_res=POISSON_RES).main(cams,
                                                       stage_times=times)
    whole = time.perf_counter() - t0
    say(f"meshing layers, flagship depth-normal Poisson (4 cameras at "
        f"{size}x{size}, grid {POISSON_RES}, host clock): "
        f"{stage_line(times, ('render', 'back-project') + POISSON_STAGES)}; "
        f"whole {whole:.4f} s; {len(res['points'])} points, "
        f"{len(res['vertices'])} vertices, {len(res['faces'])} faces")


def hold_transfer(exporter, res, dev):
    """The k-NN transfer of normals ++ latents to a seeded sample of the
    mesh's vertices, on the card against the CPU: the same neighbour sets
    and values within rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(0)
    pick = rng.choice(len(res["vertices"]), TRANSFER_SAMPLE, replace=False)
    T = res["floor_transform"]
    q = ((res["vertices"][pick] - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    alive = exporter.alive
    values = torch.cat([exporter.splat_normals(),
                        exporter.params["distill_features"][alive]], -1)
    src = exporter.params["means"][alive]
    out = []
    for d in (dev, torch.device("cpu")):
        idx, d2 = mesh_transfer.knn_neighbours(
            torch.from_numpy(q).to(d), src.to(d), k=exporter.config.transfer_k)
        out.append((idx.cpu(), mesh_transfer.apply_weights(
            idx, mesh_transfer.knn_weights(d2), values.to(d)).cpu()))
    (gi, gv), (ri, rv) = out
    if not torch.equal(gi.sort(1).values, ri.sort(1).values):
        raise AssertionError("k-NN transfer: neighbour sets differ from the "
                             "CPU's")
    torch.testing.assert_close(gv, rv, rtol=1e-5, atol=1e-6,
                               msg="k-NN transfer: card vs CPU")
    return float((gv - rv).abs().max())


@torch.no_grad()
def mesh_path(dev, ckpt, cams, render_opts):
    """Main path 7: restore path 5's checkpoint with ``load_checkpoint``,
    export a TSDF mesh with features at the bench scene's full width
    (TSDFFusionExporter over the four training cameras at 1280x720), then
    repeat it from the same state (same volume bits, same mesh.ply bytes);
    export the Poisson mesh of the splat (GaussiansToPoissonExporter at
    grid 256), hold its trilinear splat's segment sums bit-exact against
    the plain version and a repeated chi field bit-identical.  Returns the
    launches of the two exports, the TSDF mesh's vertex latents (its
    mesh_features.npz) and the checkpoint's decoder, for path 8's query."""
    step, params, alive, extras = checkpoint.load_checkpoint(ckpt,
                                                              device=dev)
    latent = params["distill_features"].shape[1]
    if step != SAVE_AT or latent != 13:
        raise AssertionError(f"checkpoint {ckpt.name}: step {step}, "
                             f"latents {latent}")
    if mesh_native.load() is None:
        raise AssertionError("libmesh_repair.so was not built or loaded")
    spec = get_method("rade-features")
    model = dataclasses.replace(spec.make_trainer_config(
        feature_dims=FEATURE_DIMS, rasterize_mode="antialiased").model,
        render=render_opts)
    ecfg = exporters.TSDFExporterConfig(depth_trunc=MESH_DEPTH_TRUNC)
    shutil.rmtree(MESH_DIR, ignore_errors=True)

    def export(out_dir, times=None):
        ex = exporters.TSDFFusionExporter(params, alive, model, ecfg)
        return ex, ex.main(cams, out_dir, stage_times=times)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    reset_counts()
    t0 = time.perf_counter()
    ex, res = export(MESH_DIR / "tsdf", times)
    whole = time.perf_counter() - t0
    tsdf_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(cams)
    want = {k: {"decode": n, "composite": n}.get(k, 0) for k in tsdf_launches}
    if tsdf_launches != want:
        raise AssertionError(f"TSDF export: launches {tsdf_launches}, "
                             f"expected {want}")
    lengths = check_mesh(res, "TSDF export", latent)
    files = {f: (MESH_DIR / "tsdf" / f).stat().st_size
             for f in ("splats.ply", "mesh.ply", "mesh_features.npz")}
    with np.load(MESH_DIR / "tsdf" / "mesh_features.npz") as data:
        vertex_latents = data["features"]
    tcfg, vol = ex.tsdf_config, ex.volume
    say(f"main path 7 (mesh extraction): restored {ckpt.name} (step {step}, "
        f"capacity {alive.shape[0]}, {int(alive.sum())} alive, latent "
        f"{latent}) with load_checkpoint; TSDFFusionExporter over {n} "
        f"cameras at {cams[0].width}x{cams[0].height}, depth_trunc "
        f"{MESH_DEPTH_TRUNC}, voxel {tcfg.voxel_size}, sdf_trunc "
        f"{tcfg.sdf_trunc}, dims {tcfg.dims} ({math.prod(tcfg.dims)} voxels, "
        f"{100 * float((vol.weight > 0).float().mean()):.2f}% observed), "
        f"feature volume {tuple(vol.features.shape)}; launches "
        f"{ {k: v for k, v in tsdf_launches.items() if v} }; "
        f"{len(res['vertices'])} vertices, {len(res['faces'])} faces, "
        f"features {res['features'].shape}, normal lengths min "
        f"{lengths.min():.4f} mean {lengths.mean():.4f}; files {files}; "
        f"peak device memory {peak / 2 ** 30:.2f} GiB; libmesh_repair.so "
        f"loaded")
    per_cam = {k: times[k] for k in ("render", "integrate")}
    say(f"meshing layers, TSDF export (host clock): "
        f"{stage_line(times, MESH_STAGES)}; render per camera "
        f"{1e3 * statistics.median(per_cam['render']):.4f} ms, integrate "
        f"per camera {1e3 * statistics.median(per_cam['integrate']):.4f} "
        f"ms (medians); whole export {whole:.4f} s")
    terr = hold_transfer(ex, res, dev)
    say(f"k-NN transfer: {TRANSFER_SAMPLE} seeded vertices, card vs CPU "
        f"over {int(alive.sum())} sources: neighbour sets equal, max abs err "
        f"{terr:.3g}")

    ex2, res2 = export(MESH_DIR / "tsdf_repeat")
    for name in ("tsdf", "weight", "color", "features"):
        if not torch.equal(getattr(vol, name), getattr(ex2.volume, name)):
            raise AssertionError(f"repeated TSDF export: {name} differs")
    mesh_a = (MESH_DIR / "tsdf" / "mesh.ply").read_bytes()
    mesh_b = (MESH_DIR / "tsdf_repeat" / "mesh.ply").read_bytes()
    if mesh_a != mesh_b:
        raise AssertionError("repeated TSDF export: mesh.ply differs")
    say(f"determinism: the TSDF export repeated from the same state gave "
        f"bit-identical tsdf, weight, color and feature volumes and the "
        f"same mesh.ply ({len(mesh_a)} bytes)")
    del ex, ex2, vol, res2
    torch.cuda.empty_cache()

    # The Poisson route on the same splat.
    gp = exporters.GaussiansToPoissonExporter(params, alive, model,
                                              grid_res=POISSON_RES)
    ptimes = {}
    reset_counts()
    t0 = time.perf_counter()
    pres = gp.main(MESH_DIR / "poisson", stage_times=ptimes)
    pwhole = time.perf_counter() - t0
    poisson_launches = counts()
    want = {k: {"segment_sum": 2}.get(k, 0) for k in poisson_launches}
    if poisson_launches != want:
        raise AssertionError(f"Poisson export: launches {poisson_launches}, "
                             f"expected {want}")
    if len(pres["faces"]) == 0 or pres["faces"].max() >= len(
            pres["vertices"]) or not np.isfinite(pres["vertices"]).all():
        raise AssertionError("Poisson export: no valid mesh")
    say(f"main path 7 (Poisson): GaussiansToPoissonExporter at grid "
        f"{POISSON_RES} over {len(pres['points'])} splats (opacity > 0.1): "
        f"launches { {k: v for k, v in poisson_launches.items() if v} }; "
        f"{len(pres['vertices'])} vertices, {len(pres['faces'])} faces")
    say(f"meshing layers, Poisson export (host clock): "
        f"{stage_line(ptimes, POISSON_STAGES)}; whole export {pwhole:.4f} "
        f"s")

    # Kernel 4 on the splat's own rows (normals ++ 1 at the eight corners).
    pts_vox = poisson.voxel_coords(pres["points"], POISSON_RES)[0]
    pts_t = torch.from_numpy(pts_vox).to(dev)
    nrm_t = torch.from_numpy(pres["normals"]).to(dev)
    ids, rows = poisson.scatter_rows(
        POISSON_RES, pts_t, torch.cat([nrm_t, torch.ones_like(nrm_t[:, :1])],
                                      -1))
    n_vox = POISSON_RES ** 3
    sorted_ids, order = torch.sort(ids, stable=True)
    check_segsum_rows(sorted_ids, order, rows, n_vox, "Poisson splat")
    chi = poisson._poisson_field(pts_t, nrm_t, POISSON_RES, 0.0)
    if not torch.equal(chi, poisson._poisson_field(pts_t, nrm_t,
                                                   POISSON_RES, 0.0)):
        raise AssertionError("Poisson: a repeated chi field differs")
    m, d = rows.shape
    rec = {
        "ms": median_ms(lambda: segsum_kernel.segment_sum_sorted(
            sorted_ids, order, rows, n_vox)),
        "plain_ms": median_ms(lambda: segsum_kernel.segment_sum_plain(
            sorted_ids, order, rows, n_vox)),
        "library_ms": median_ms(lambda: torch.zeros(
            (n_vox, d), device=dev).index_add_(0, ids.long(), rows)),
        "sort_ms": median_ms(lambda: torch.sort(ids, stable=True)),
        "bound": segsum_bound(m, d, n_vox),
    }
    say(f"kernel 4 at the Poisson splat (M={m}, D={d}, n={n_vox}): "
        f"bit-identical to its plain version, repeat bit-identical; kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, index_add_ "
        f"{rec['library_ms']:.4f} ms, stable sort {rec['sort_ms']:.4f} ms, "
        f"bound {rec['bound'][0]:.4f} ms by {rec['bound'][1]} (median of "
        f"{REPS}); chi {tuple(chi.shape)} repeated bit-identical")
    del pts_t, nrm_t, ids, rows, sorted_ids, order, chi
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    decoder = decoder_lib.decoder_from_numpy(
        checkpoint.decoder_arrays(extras), device=dev)
    return ({k: tsdf_launches[k] + poisson_launches[k]
             for k in tsdf_launches}, vertex_latents, decoder)


# ------------------------------------------------ main path 8: the towers
# The feature towers at their released shapes, with weights drawn from
# seeded generators and written in the converters' npz layouts
# (scripts/convert_weights.py, convert_sam.py, convert_yolo.py) into a
# temporary directory outside the checkout, then loaded through each entry
# point's weights file, as a user's converted checkpoint is.
CLIP_L14_336 = dict(visual=dict(dim=1024, n_blocks=24, patch_size=14,
                                embed_dim=768, grid=24),
                    text=dict(dim=768, n_blocks=12, vocab=49408, context=77,
                              embed_dim=768))
DINOV2_S14 = dict(dim=384, n_blocks=12, patch_size=14, mlp_ratio=4, grid=37)
# Trained DINOv2 checkpoints carry LayerScale gammas of order 0.1; the
# init's 1e-5 would leave the blocks out of every output.
DINOV2_LAYER_SCALE = 0.1
SAM_VIT_B = dict(dim=768, n_blocks=12, heads=12, window=14,
                 global_blocks=(2, 5, 8, 11))
# YOLOv8x (width 1.25, depth 1.0, max channels 512 * 1.25): the size of
# MobileSAMv2's ObjectAwareModel.pt (68M parameters, 138 MB in fp16).
YOLOV8X = dict(widths=(80, 160, 320, 640, 640), repeats=(3, 6, 6, 3),
               head_repeats=3, nc=1)
# Random weights put SAM's predicted IoU anywhere; the IoU head's last bias
# at 0.92 lets the masks pass the composite's 0.85 confidence gate, so the
# grouping has masks to work on.
SAM_IOU_BIAS = 0.92
TOWER_STEPS = 12         # rade-features steps on the extracted maps
TOWER_MAPS = {"clip-vit": (768, 35, 64), "dinov2": (384, 32, 57)}
# Card against CPU: max abs err / max|ref|.  Both run float32 with TF32
# off; on one H100 every tower came within 2.2e-6.
TOWER_LIMIT = 1e-5
GROUPING_GAUSSIANS = 1_000_000
SOT, EOT = 49406, 49407  # CLIP's start and end of text


def to_numpy(params):
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def sam_params(seed, dim=768, n_blocks=12, heads=12, window=14,
               global_blocks=(2, 5, 8, 11)):
    """SAM's encoder, prompt encoder and two-way decoder in the layout of
    ``scripts/convert_sam.py`` (numpy): linear weights normal with variance
    1 / fan_in, zero biases, unit LayerNorms, rel-pos tables 2 * window - 1
    long (127 in the global blocks), the IoU head's last bias at
    SAM_IOU_BIAS."""
    rng = np.random.default_rng(seed)

    def w(*shape, fan_in=None):
        fan = fan_in or shape[0]
        return (rng.standard_normal(shape) / math.sqrt(fan)).astype(
            np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ln(p, pre, d):
        p[f"{pre}.scale"], p[f"{pre}.bias"] = np.ones(d, np.float32), \
            zeros(d)

    p = {"enc.patch_embed.w": w(16 * 16 * 3, dim),
         "enc.patch_embed.b": zeros(dim),
         "enc.pos_embed": 0.02 * w(64, 64, dim, fan_in=1),
         "enc.n_blocks": np.asarray(n_blocks), "enc.window": np.asarray(window),
         "enc.num_heads": np.asarray(heads),
         "enc.global_blocks": np.asarray(global_blocks)}
    for i in range(n_blocks):
        pre = f"enc.blocks.{i}"
        ln(p, f"{pre}.ln1", dim)
        ln(p, f"{pre}.ln2", dim)
        rel = 2 * (64 if i in global_blocks else window) - 1
        p.update({f"{pre}.attn.qkv.w": w(dim, 3 * dim),
                  f"{pre}.attn.qkv.b": zeros(3 * dim),
                  f"{pre}.attn.proj.w": w(dim, dim),
                  f"{pre}.attn.proj.b": zeros(dim),
                  f"{pre}.attn.rel_pos_h": 0.02 * w(rel, dim // heads,
                                                    fan_in=1),
                  f"{pre}.attn.rel_pos_w": 0.02 * w(rel, dim // heads,
                                                    fan_in=1),
                  f"{pre}.mlp.w1": w(dim, 4 * dim),
                  f"{pre}.mlp.b1": zeros(4 * dim),
                  f"{pre}.mlp.w2": w(4 * dim, dim),
                  f"{pre}.mlp.b2": zeros(dim)})
    p["enc.neck.conv1.w"] = w(dim, 256)
    ln(p, "enc.neck.ln1", 256)
    p["enc.neck.conv2.w"] = w(3, 3, 256, 256, fan_in=9 * 256)
    ln(p, "enc.neck.ln2", 256)
    p["prompt.pe_gauss"] = w(2, 128, fan_in=1)
    for i in range(4):
        p[f"prompt.point_embed.{i}"] = w(256, fan_in=1)
    p["prompt.not_a_point"] = w(256, fan_in=1)
    p["prompt.no_mask"] = w(256, fan_in=1)
    p.update({"dec.iou_token": w(256, fan_in=1),
              "dec.mask_tokens": w(4, 256, fan_in=1),
              "dec.n_layers": np.asarray(2), "dec.num_heads": np.asarray(8)})

    def attn(pre, inner):
        for nm in "qkv":
            p[f"{pre}.{nm}.w"], p[f"{pre}.{nm}.b"] = w(256, inner), \
                zeros(inner)
        p[f"{pre}.out.w"], p[f"{pre}.out.b"] = w(inner, 256), zeros(256)

    for i in range(2):
        pre = f"dec.layers.{i}"
        attn(f"{pre}.self_attn", 256)
        attn(f"{pre}.cross_t2i", 128)
        attn(f"{pre}.cross_i2t", 128)
        for j in (1, 2, 3, 4):
            ln(p, f"{pre}.ln{j}", 256)
        p.update({f"{pre}.mlp.w1": w(256, 2048), f"{pre}.mlp.b1": zeros(2048),
                  f"{pre}.mlp.w2": w(2048, 256), f"{pre}.mlp.b2": zeros(256)})
    attn("dec.final_attn", 128)
    ln(p, "dec.ln_final", 256)
    p.update({"dec.up1.w": w(2, 2, 64, 256, fan_in=256),
              "dec.up1.b": zeros(64),
              "dec.up2.w": w(2, 2, 32, 64, fan_in=64), "dec.up2.b": zeros(32)})
    ln(p, "dec.up_ln", 64)
    for j in range(4):
        for li, (a, b) in enumerate(((256, 256), (256, 256), (256, 32))):
            p[f"dec.hyper.{j}.w{li}"], p[f"dec.hyper.{j}.b{li}"] = \
                w(a, b), zeros(b)
    for li, (a, b) in enumerate(((256, 256), (256, 256), (256, 4))):
        p[f"dec.iou_head.w{li}"], p[f"dec.iou_head.b{li}"] = w(a, b), zeros(b)
    p["dec.iou_head.w2"] *= 0.01
    p["dec.iou_head.b2"] = np.full(4, SAM_IOU_BIAS, np.float32)
    return p


def yolo_params(seed, widths=(80, 160, 320, 640, 640), repeats=(3, 6, 6, 3),
                head_repeats=3, nc=1):
    """YOLOv8's detect model in the layout of ``scripts/convert_yolo.py``
    (numpy, each conv with its BatchNorm fused): HWIO weights normal with
    variance 2 / fan_in, zero biases."""
    rng = np.random.default_rng(seed)
    p = {}

    def conv(name, cin, cout, k):
        p[f"{name}.w"] = (rng.standard_normal((k, k, cin, cout))
                          * math.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        p[f"{name}.b"] = np.zeros(cout, np.float32)

    def c2f(idx, cin, cout, n):
        h = cout // 2
        conv(f"{idx}.cv1", cin, cout, 1)
        for j in range(n):
            conv(f"{idx}.m.{j}.cv1", h, h, 3)
            conv(f"{idx}.m.{j}.cv2", h, h, 3)
        conv(f"{idx}.cv2", h * (2 + n), cout, 1)

    c0, c1, c2, c3, c4 = widths
    r0, r1, r2, r3 = repeats
    conv("0", 3, c0, 3)
    conv("1", c0, c1, 3)
    c2f("2", c1, c1, r0)
    conv("3", c1, c2, 3)
    c2f("4", c2, c2, r1)
    conv("5", c2, c3, 3)
    c2f("6", c3, c3, r2)
    conv("7", c3, c4, 3)
    c2f("8", c4, c4, r3)
    conv("9.cv1", c4, c4 // 2, 1)
    conv("9.cv2", c4 // 2 * 4, c4, 1)
    c2f("12", c4 + c3, c3, head_repeats)
    c2f("15", c3 + c2, c2, head_repeats)
    conv("16", c2, c2, 3)
    c2f("18", c2 + c3, c3, head_repeats)
    conv("19", c3, c3, 3)
    c2f("21", c3 + c4, c4, head_repeats)
    box_ch = max(16, c2 // 4, 4 * 16)
    cls_ch = max(c2, min(nc, 100))
    for lvl, ch in enumerate((c2, c3, c4)):
        for branch, mid, out in (("cv2", box_ch, 4 * 16), ("cv3", cls_ch,
                                                           nc)):
            conv(f"22.{branch}.{lvl}.0", ch, mid, 3)
            conv(f"22.{branch}.{lvl}.1", mid, mid, 3)
            conv(f"22.{branch}.{lvl}.2", mid, out, 1)
    return p


def write_tower_weights(directory, dev, clip=CLIP_L14_336, dino=DINOV2_S14,
                        sam=SAM_VIT_B, yolo=YOLOV8X):
    """The four weights files under the names the entry points look for;
    returns {file: (path, parameter count)}."""
    gen = torch.Generator(device=dev).manual_seed(91)
    dino_p = vit.init_dinov2_params(gen, device=dev, **dino)
    for k in dino_p:
        if k.endswith((".ls1", ".ls2")):
            dino_p[k].fill_(DINOV2_LAYER_SCALE)
    files = {
        "clip_vitl14_336.npz": lambda: to_numpy({
            **vit.init_clip_visual_params(gen, device=dev, **clip["visual"]),
            **vit.init_clip_text_params(gen, device=dev, **clip["text"])}),
        "dinov2_vits14.npz": lambda: to_numpy(dino_p),
        "sam_vit_b.npz": lambda: sam_params(92, **sam),
        "yolov8_objaware.npz": lambda: yolo_params(93, **yolo),
    }
    out = {}
    for name, make in files.items():
        arrays = make()
        path = Path(directory) / name
        np.savez(path, **arrays)
        out[name] = (path, sum(a.size for a in arrays.values()
                               if a.dtype == np.float32))
        del arrays
    del dino_p
    torch.cuda.empty_cache()
    return out


def vit_flops(tokens, dim, blocks, attended=None):
    """Multiply-adds x 2 of ``blocks`` pre-norm ViT blocks (MLP ratio 4)
    over ``tokens``: 24 T D^2 for the products, 4 T_a^2 D / (T / T_a) for
    attention over groups of ``attended`` tokens (windows; all by
    default)."""
    attended = attended or tokens
    return blocks * (24 * tokens * dim ** 2 + 4 * tokens * attended * dim)


def clip_block_layers(params, x, heads):
    """Card ms of the pieces of CLIP's first visual block on tokens ``x``
    [T, D] (median of REPS): the q/k/v products, the scores, the softmax,
    the weighted sum, the output product, the MLP, the LayerNorms."""
    p, pre = params, "visual.blocks.0"
    t, d = x.shape
    hd = d // heads
    q = (x @ p[f"{pre}.attn.wq"]).reshape(t, heads, hd).transpose(0, 1)
    att = torch.softmax(q @ q.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    return {
        "layer norms (2)": 2 * median_ms(lambda: vit.layer_norm(
            x, p[f"{pre}.ln1.scale"], p[f"{pre}.ln1.bias"], 1e-5)),
        "q, k, v products": 3 * median_ms(
            lambda: x @ p[f"{pre}.attn.wq"] + p[f"{pre}.attn.bq"]),
        "scores q kT": median_ms(lambda: q @ q.transpose(-1, -2)),
        "softmax": median_ms(lambda: torch.softmax(att, dim=-1)),
        "weighted sum": median_ms(lambda: att @ q),
        "output product": median_ms(
            lambda: x @ p[f"{pre}.attn.wo"] + p[f"{pre}.attn.bo"]),
        "MLP (two products, QuickGELU)": median_ms(lambda: vit.quick_gelu(
            x @ p[f"{pre}.mlp.w1"] + p[f"{pre}.mlp.b1"]) @ p[f"{pre}.mlp.w2"]),
        "whole block": median_ms(lambda: vit.clip_block(x, p, 0, heads)),
    }


def rel_err(got, ref):
    """max |got - ref| / max |ref| of a card tensor against a CPU one."""
    ref = ref.float()
    return float((got.cpu().float() - ref).abs().max() / ref.abs().max())


def uint8_image(rgb):
    return (rgb.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()


def seeded_tokens(seed, length=9):
    """77 CLIP ids: <sot>, ``length`` seeded vocabulary ids, <eot>, zeros
    (the layout ``ClipTokenizer.encode`` gives)."""
    ids = torch.randint(1, SOT, (length,),
                        generator=torch.Generator().manual_seed(seed))
    out = torch.zeros(77, dtype=torch.int64)
    out[0], out[1:length + 1], out[length + 1] = SOT, ids, EOT
    return out


def tower_times(extractor, images):
    """Host ms of each image through one extractor (synchronised)."""
    out = []
    for img in images:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extractor(img.astype(np.float32) / 255.0)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def segment_and_group(seg, views, metas, n):
    """Every view through ``GroupingClassifier.associate`` (segmentation,
    composite, front-most Gaussians, bank matching): the matched-label
    masks, the classifier and the host ms per view."""
    gc = grouping.GroupingClassifier(n, segmentation=seg)
    matched, ms = [], []
    for img, meta in zip(views, metas):
        m, t = host_ms(lambda: gc.associate(img, meta))
        matched.append(m)
        ms.append(t)
    return matched, gc, ms


@contextlib.contextmanager
def tower_weights(dev):
    """A temporary directory outside the checkout holding the four tower
    weights files, with ``COLLAB_SPLATS_WEIGHTS`` pointing there while the
    block runs (paths 8 to 10 find their weights through it); yields
    (directory, {file: (path, parameter count)}).  The directory is
    deleted and the variable put back after."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_towers_"))
    env = os.environ.get("COLLAB_SPLATS_WEIGHTS")
    try:
        t0 = time.perf_counter()
        weights = write_tower_weights(tmp, dev)
        say("tower weights (seeded, the converters' layouts, released "
            "shapes): " + ", ".join(
                f"{name} {count / 1e6:.1f}M parameters"
                for name, (_, count) in weights.items())
            + f"; written in {time.perf_counter() - t0:.1f} s")
        os.environ["COLLAB_SPLATS_WEIGHTS"] = str(tmp)
        extractors._default_extractor.cache_clear()
        yield tmp, weights
    finally:
        extractors._default_extractor.cache_clear()
        if env is None:
            os.environ.pop("COLLAB_SPLATS_WEIGHTS", None)
        else:
            os.environ["COLLAB_SPLATS_WEIGHTS"] = env
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def tower_path(fdata, dev, vertex_latents, ckpt_decoder, tmp, weights):
    """Main path 8: the feature towers at their released shapes.  Extract
    clip-vit and dinov2 maps from the four bench images with
    ``FeatureDatamanager`` (cached, read back), train rade-features on them
    (``"xla"``), embed a text query with the CLIP text tower and score path
    7's mesh vertices and a rendered view, segment the views with SAM
    prompted by YOLOv8 boxes and group 1M Gaussians over them; all with
    every launch count at 0 just before and read just after.  Then every
    kernel on a step's own inputs, the repeats (same bits), and each tower
    card against CPU.  The weights are ``tower_weights``'s, in ``tmp``.
    Returns the launches and the kernels' errors."""
    images = [uint8_image(im) for im in fdata.images]
    base = FullImageDatamanager(fdata.cams, [], images, [])
    fcfg = feature_dm.FeatureDatamanagerConfig(
        feature_type="clip-vit", extractors=("clip-vit", "dinov2"),
        final_resolution=64, cache_dir=str(tmp / "cache"))
    bench = make_scene("bench", dev)
    gparams, galive, gcams, gcfg = bench
    if galive.shape[0] != GROUPING_GAUSSIANS:
        raise AssertionError("grouping scene: wrong size")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # 1. Extraction, cached.
    dm, extract_ms = host_ms(lambda: feature_dm.FeatureDatamanager(
        base, fcfg, device=dev))
    extract_peak = torch.cuda.max_memory_allocated()
    for name, ext in dm._extractors.items():
        if not (ext.pretrained and ext.device.type == dev.type):
            raise AssertionError(f"{name}: not the converted weights on "
                                 f"{dev}")
    # 2. rade-features training on the extracted maps.
    data = fdata._replace(feats=dm.train_features)
    dims = tuple(dm.feature_dims.items())
    tr = feature_trainer(data, dev, refine_every=10 ** 6,
                         feature_dims=dims)
    start = tr.state()
    hist, step_ms = [], []
    for _ in range(TOWER_STEPS):
        _, t = host_ms(lambda: tr.train(1, log_every=10 ** 9))
        hist.append(tr.history[-1])
        step_ms.append(t)
    # 3. The text query: path 7's mesh vertices, a rendered view.
    clip = dm.text_encoder()
    tokens = torch.stack([seeded_tokens(s) for s in (1, 2)]).to(dev)
    with torch.no_grad():
        emb = torch.stack([vit.clip_text_forward(clip.params, t,
                                                 clip.text_heads)
                           for t in tokens])
        emb = emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)
        model = tr.config.model
        vsim = rade_features.query_vertices(
            ckpt_decoder, torch.as_tensor(vertex_latents, device=dev), emb,
            1, model)
        out, _ = rade_gs.get_outputs(tr.params, tr.alive, fdata.cams[0],
                                     tr.step, model, training=False)
        smap = rade_features.similarity_map(tr.decoder, out, emb, 1, model)
    # 4. Segmentation and grouping over the four views.
    sam = sam_predictor.SamBackend(str(weights["sam_vit_b.npz"][0]),
                                   device=dev)
    det = yolo.ObjectAwareDetector(str(weights["yolov8_objaware.npz"][0]),
                                   device=dev)
    seg = segmentation.Segmentation(
        backend=segmentation.object_segment_image(sam, det))
    metas, views = [], []
    with torch.no_grad():
        for cam in gcams:
            o, meta = rade_gs.get_outputs(gparams, galive, cam, 0, gcfg,
                                          training=False)
            metas.append(meta)
            views.append(uint8_image(o["rgb"]))
    matched, gc, group_ms = segment_and_group(seg, views, metas,
                                              GROUPING_GAUSSIANS)
    labels = gc.gaussian_labels()
    torch.cuda.synchronize()
    launches = counts()
    path_peak = torch.cuda.max_memory_allocated()

    n_steps = TOWER_STEPS
    want = {k: 0 for k in launches}
    want.update(decode=n_steps + 1 + len(gcams),
                composite=n_steps + 1 + len(gcams), composite_bwd=n_steps,
                segment_sum=2 * n_steps)
    if launches != want:
        raise AssertionError(f"path 8: launches {launches}, expected {want}")

    # What came out: the maps' shapes, the cache read back to the bits.
    for name, shape in TOWER_MAPS.items():
        for i, fm in enumerate(dm.train_features):
            if tuple(fm[name].shape) != shape or not bool(
                    torch.isfinite(fm[name]).all()):
                raise AssertionError(f"{name} map {i}: "
                                     f"{tuple(fm[name].shape)}, want {shape}")
    cache_files = sorted((tmp / "cache").iterdir())
    dm_read, read_ms = host_ms(lambda: feature_dm.FeatureDatamanager(
        base, fcfg, device=dev))
    for a, b in zip(dm.train_features, dm_read.train_features):
        for name in a:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"feature cache: {name} read back "
                                     "differs")
    check_features_falling(hist, "main path 8")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError("path 8: a loss is not finite")
    for what, s in (("vertex similarities", vsim), ("similarity map", smap)):
        if not (bool(torch.isfinite(s).all()) and float(s.min()) >= 0.0
                and float(s.max()) <= 1.0):
            raise AssertionError(f"path 8: {what} not finite in [0, 1]")
    if smap.shape != (fdata.cams[0].height, fdata.cams[0].width, 1) or \
            vsim.shape != (len(vertex_latents),):
        raise AssertionError("path 8: similarity shapes")
    for i, m in enumerate(matched):
        if m.shape != (gcams[i].height, gcams[i].width):
            raise AssertionError(f"grouping view {i}: mask {m.shape}")
    if labels.shape != (GROUPING_GAUSSIANS,):
        raise AssertionError("grouping: label shape")
    ext_ms = {name: tower_times(ext, images)
              for name, ext in dm._extractors.items()}
    tokens_per, flops = {}, {}
    for name, ext in dm._extractors.items():
        _, ph, pw = extractors._prep_image(
            images[0], ext.resolution, ext.patch_size, ext.mean, ext.std,
            dev)
        tokens_per[name] = ph * pw + 1
        pre = "visual." if name == "clip-vit" else ""
        flops[name] = vit_flops(
            tokens_per[name], ext.params[f"{pre}patch_embed.w"].shape[1],
            int(ext.params[f"{pre}n_blocks"]))
    say(f"main path 8 (feature towers, released shapes, weights through "
        f"their npz files): FeatureDatamanager over {len(images)} images "
        f"at {images[0].shape[1]}x{images[0].shape[0]}, maps "
        + ", ".join(f"{k} {v}" for k, v in dm.feature_dims.items())
        + f"; extraction {extract_ms:.1f} ms with the cache write, read "
        f"back bit-identical in {read_ms:.1f} ms ({cache_files[0].name}, "
        f"{cache_files[0].stat().st_size / 2 ** 20:.1f} MiB); per image "
        + "; ".join(f"{k} ({tokens_per[k]} tokens, {flops[k] / 1e12:.3f} "
                    f"TFLOP) median {statistics.median(v):.2f} ms (min "
                    f"{min(v):.2f}, max {max(v):.2f}; "
                    f"{flops[k] / statistics.median(v) / 1e9:.1f} TFLOP/s)"
                    for k, v in ext_ms.items())
        + f"; peak device memory {extract_peak / 2 ** 30:.2f} GiB in the "
        f"extraction, {path_peak / 2 ** 30:.2f} GiB in the path; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    say(f"path 8 training: {n_steps} rade-features steps (xla) on the "
        f"extracted maps, losses " + ", ".join(
            f"{h['loss']:.5f}" for h in hist)
        + f"; step median {statistics.median(step_ms):.2f} ms (host clock)")
    say(f"path 8 query: the CLIP text tower "
        f"({int(clip.params['text.n_blocks'])} blocks, width "
        f"{clip.params['text.ln_final.scale'].shape[0]}) on two "
        f"seeded 77-id sequences, called directly: the BPE vocabulary is not "
        f"in the repository, so encode_text would take its offline branch; "
        f"query_vertices over {len(vertex_latents)} vertices of path 7's "
        f"mesh_features.npz (path 5's decoder) in [{float(vsim.min()):.4f}, "
        f"{float(vsim.max()):.4f}], similarity_map of camera 0 "
        f"{tuple(smap.shape)} in [{float(smap.min()):.4f}, "
        f"{float(smap.max()):.4f}]")

    # The CLIP tower's first block, piece by piece, at the extraction's
    # 2,994 tokens.
    with torch.no_grad():
        ext = dm._extractors["clip-vit"]
        img, ph, pw = extractors._prep_image(
            images[0].astype(np.float32) / 255.0, ext.resolution,
            ext.patch_size, ext.mean, ext.std, dev)
        x = torch.cat([ext.params["visual.class_embedding"][None],
                       vit.patchify(img, ext.patch_size)
                       @ ext.params["visual.patch_embed.w"]])
        pieces = clip_block_layers(ext.params, x, ext.num_heads)
        del x, img
    say(f"path 8 CLIP block 0 at {ph * pw + 1} tokens (card, median of "
        f"{REPS}, ms): " + ", ".join(f"{k} {v:.4f}"
                                     for k, v in pieces.items()))

    # Stage times of segmentation (outside the counted run).
    _, det_ms = host_ms(lambda: det(views[0]))
    boxes, confs = det(views[0])
    _, enc_ms = host_ms(lambda: sam.set_image(views[0]))
    sam_dim = sam.params["enc.patch_embed.b"].shape[0]
    n_glob = len(sam.params["enc.global_blocks"])
    n_win = int(sam.params["enc.n_blocks"]) - n_glob
    enc_flops = (vit_flops(25 * 196, sam_dim, n_win, attended=196)
                 + vit_flops(4096, sam_dim, n_glob))
    _, dec_ms = host_ms(lambda: sam.predict_boxes(boxes[:64]))
    results, seg_ms = host_ms(lambda: seg.auto_segment_image(views[0]))
    comp, comp_ms = host_ms(lambda: segmentation.create_composite_mask(
        results, 0.85))
    _, group0_ms = host_ms(lambda: grouping.GroupingClassifier(
        GROUPING_GAUSSIANS, segmentation=seg).associate(
            views[0], metas[0], composite_mask=comp))
    n_masks = [int(m.max()) for m in matched]
    say(f"path 8 segmentation and grouping: {len(views)} views at "
        f"{views[0].shape[1]}x{views[0].shape[0]}, YOLOv8x boxes then SAM "
        f"ViT-B masks (object_segment_image); view 0: detector "
        f"{det_ms:.2f} ms ({len(boxes)} boxes after NMS), encoder "
        f"{enc_ms:.2f} ms ({enc_flops / 1e12:.3f} TFLOP in its blocks, "
        f"{enc_flops / enc_ms / 1e9:.1f} TFLOP/s), decoder and postprocess "
        f"of 64 boxes "
        f"{dec_ms:.2f} ms (host clock); auto_segment_image {seg_ms:.0f} ms "
        f"({len(results)} masks), create_composite_mask {comp_ms:.0f} ms, "
        f"the grouping given the composite {group0_ms:.0f} ms; associate "
        f"per view "
        + ", ".join(f"{t:.0f}" for t in group_ms)
        + f" ms; matched objects per view {n_masks}, {gc.num_objects} "
        f"objects in the bank, {int((labels >= 0).sum())} of "
        f"{GROUPING_GAUSSIANS} Gaussians labelled")

    # Every kernel of the step on its own inputs.
    tr.load_state(start)
    _, kin = train_layer_times(tr)
    tr.load_state(start)
    errs = check_step_kernels(kin, False, "path 8 rade-features step",
                              tr.config.model.render.stop_threshold)
    del tr, start, kin
    torch.cuda.empty_cache()

    # Repeats: the extraction without the cache, the segmentation and the
    # grouping from scratch, to the same bits.
    dm2 = feature_dm.FeatureDatamanager(
        base, dataclasses.replace(fcfg, cache_dir=None), device=dev)
    for a, b in zip(dm.train_features, dm2.train_features):
        for name in a:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"repeated extraction: {name} differs")
    matched2, gc2, _ = segment_and_group(seg, views, metas,
                                         GROUPING_GAUSSIANS)
    if not all(np.array_equal(a, b) for a, b in zip(matched, matched2)) or \
            not np.array_equal(gc.votes, gc2.votes) or \
            not np.array_equal(labels, gc2.gaussian_labels()):
        raise AssertionError("repeated segmentation and grouping differ")
    say("path 8 determinism: a repeated extraction (no cache), "
        "segmentation and grouping gave the same bits (maps, matched "
        "masks, votes, labels)")
    del dm2, gc2, matched2

    # Each tower on the card against the port's own module on the CPU.
    torch.set_num_threads(8)
    rng = np.random.default_rng(17)
    img224 = torch.as_tensor(rng.normal(size=(224, 224, 3)),
                             dtype=torch.float32)
    errs_cpu = {}
    dino = dm._extractors["dinov2"]
    dino_cpu = extractors.DINOv2Extractor(
        weights_npz=str(weights["dinov2_vits14.npz"][0]), device="cpu")
    with torch.no_grad():
        errs_cpu["dinov2 (224x224)"] = rel_err(
            vit.dinov2_forward(dino.params, img224.to(dev), dino.num_heads,
                               14),
            vit.dinov2_forward(dino_cpu.params, img224, dino_cpu.num_heads,
                               14))
        del dino_cpu
        clip_cpu = extractors.MaskCLIPExtractor(
            weights_npz=str(weights["clip_vitl14_336.npz"][0]), device="cpu")
        errs_cpu["clip visual (224x224)"] = rel_err(
            vit.maskclip_forward(clip.params, img224.to(dev), clip.num_heads,
                                 14),
            vit.maskclip_forward(clip_cpu.params, img224, clip_cpu.num_heads,
                                 14))
        errs_cpu["clip text (77 ids)"] = rel_err(
            vit.clip_text_forward(clip.params, tokens[0], clip.text_heads),
            vit.clip_text_forward(clip_cpu.params, tokens[0].cpu(),
                                  clip_cpu.text_heads))
        del clip_cpu
        sam_cpu = sam_predictor.SamBackend(
            str(weights["sam_vit_b.npz"][0]), device="cpu")
        img1024 = torch.as_tensor(rng.normal(size=(1024, 1024, 3)),
                                  dtype=torch.float32)
        emb_card = sam_mod.sam_encoder_forward(sam.params, img1024.to(dev))
        errs_cpu["sam encoder (1024)"] = rel_err(
            emb_card, sam_mod.sam_encoder_forward(sam_cpu.params, img1024))
        box = torch.tensor([[100.0, 200.0, 700.0, 600.0]])
        low, iou = sam_mod.mask_decoder_forward(
            sam.params, emb_card, sam._pe,
            sam_mod.encode_boxes(sam.params, box.to(dev)))
        low_c, iou_c = sam_mod.mask_decoder_forward(
            sam_cpu.params, emb_card.cpu(), sam_cpu._pe,
            sam_mod.encode_boxes(sam_cpu.params, box))
        errs_cpu["sam decoder (one box)"] = max(rel_err(low, low_c),
                                                rel_err(iou, iou_c))
        del sam_cpu, emb_card
        det_cpu = yolo.ObjectAwareDetector(
            str(weights["yolov8_objaware.npz"][0]), device="cpu")
        padded, _ = det.letterbox(views[0])
        b_card, s_card = yolo.yolo_forward(det.params, padded)
        b_cpu, s_cpu = yolo.yolo_forward(det_cpu.params, padded.cpu())
        errs_cpu[f"yolov8x head ({padded.shape[1]}x{padded.shape[0]} "
                 f"letterbox, boxes, scores)"] = max(rel_err(b_card, b_cpu),
                                                     rel_err(s_card, s_cpu))
        del det_cpu
    say("path 8 card against CPU (the port's own modules, max abs err / "
        f"max|ref|, limit {TOWER_LIMIT:g}): " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs_cpu.items()))
    bad = {k: v for k, v in errs_cpu.items() if not v <= TOWER_LIMIT}
    if bad:
        raise AssertionError(f"path 8 card against CPU over the limit: {bad}")
    return {"launches": launches, "errs": errs}


# ------------------------------------------- main path 9: trainer options
# The bench training scene (path 2's) with pose optimisation and bilateral
# grids on, the depth-normal loss from step 4, an eval image every 4 steps
# with LPIPS on seeded VGG16 weights, JSONL and TensorBoard writers, and
# every frame streamed from pinned host memory (budget 0).
OPTIONS_STEPS = 12
OPTIONS_REG_FROM = 4
OPTIONS_EVAL_EVERY = 4
PLAIN_STEPS = 6          # steps of the same trainer without the options
VGG16_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                512)
VGG16_STAGE_ENDS = (1, 3, 6, 9, 12)


def write_vgg16_weights(directory, dev):
    """VGG16 LPIPS weights at the released shapes in
    ``scripts/convert_weights.py``'s layout (conv{j}.w [out, in, 3, 3],
    conv{j}.b, lin{i} over each stage's channels), drawn from a seeded
    generator (He-scaled normal convolutions, uniform heads); returns the
    parameter count."""
    gen = torch.Generator(device=dev).manual_seed(94)
    out, cin = {}, 3
    for j, cout in enumerate(VGG16_WIDTHS):
        out[f"conv{j}.w"] = torch.randn((cout, cin, 3, 3), generator=gen,
                                        device=dev) * math.sqrt(2 / (9 * cin))
        out[f"conv{j}.b"] = 0.01 * torch.randn(cout, generator=gen,
                                               device=dev)
        cin = cout
    for i, j in enumerate(VGG16_STAGE_ENDS):
        out[f"lin{i}"] = torch.rand(VGG16_WIDTHS[j], generator=gen,
                                    device=dev)
    arrays = to_numpy(out)
    np.savez(Path(directory) / "vgg16_lpips.npz", **arrays)
    return sum(a.size for a in arrays.values())


def vgg16_flops(height, width):
    """Multiply-adds x 2 of VGG16's thirteen 3x3 convolutions on one
    image: 2 * 9 * H * W * C_in * C_out per convolution, the size halved
    after each of the first four stages."""
    flops, cin, h, w = 0, 3, height, width
    for j, cout in enumerate(VGG16_WIDTHS):
        flops += 2 * 9 * h * w * cin * cout
        cin = cout
        if j in VGG16_STAGE_ENDS[:4]:
            h, w = h // 2, w // 2
    return flops


def options_trainer(model, cams, images, init, alive, dev, options=True,
                    budget=0, writers=None):
    conf = TrainerConfig(
        model=model, max_iterations=1000, seed=0,
        steps_per_eval_image=OPTIONS_EVAL_EVERY,
        steps_per_eval_all_images=10 ** 6,
        strategy=strategy.StrategyConfig(warmup_length=4,
                                         refine_every=REFINE_EVERY),
        optimize_camera_poses=options, use_bilateral_grid=options,
        dataset_hbm_budget_bytes=budget)
    return Trainer(conf, cams, images, init, alive, device=dev,
                   writers=writers)


def kernel_inputs_of(step):
    """``step()`` run with every kernel wrapper's arguments captured (the
    decode's, the compositing forward's, its backward's with the loss's
    cotangent, and every segment sum's)."""
    with captured(tiles, "decode_bin_keys", 1) as dec, \
            captured(batched, "composite_batched_fwd", 1) as fwd, \
            captured(batched, "composite_batched_bwd", 1) as bwd, \
            captured(segsum, "segment_sum_sorted") as seg:
        step()
    return {"decode_args": detached(dec[0]), "fwd_args": detached(fwd[0]),
            "bwd_args": detached(bwd[0]), "step_segsum_args": detached(seg)}


def step_kernel_inputs(tr):
    """The kernel inputs of one step of ``tr``, then the trainer's state
    put back."""
    snap = tr.state()
    kin = kernel_inputs_of(tr.train_one_step)
    tr.load_state(snap)
    tr.history.pop()
    return kin


def same_trainer_state(a, b):
    """Names of the entries in which two ``Trainer.state()`` differ."""
    bad = [f"params {k}" for k in a["params"]
           if not torch.equal(a["params"][k], b["params"][k])]
    bad += [f"camera {k}" for k in a["camera_params"]
            if not torch.equal(a["camera_params"][k], b["camera_params"][k])]
    bad += [f"statistic {i}" for i, (x, y) in
            enumerate(zip(a["strat_state"], b["strat_state"]))
            if not torch.equal(x, y)]
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            if not torch.equal(v, b["optimizer"]["state"][i][k]):
                bad.append(f"Adam {i} {k}")
    return bad


def options_path(dev, weights_dir):
    """Main path 9: the trainer's options at the bench training scene's
    width (1M Gaussians at capacity 1,262,144, sh_degree 3, 1280x720, four
    cameras, ``"xla"``): twelve steps with pose optimisation and bilateral
    grids on, the depth-normal loss from step 4, an eval image every four
    steps with LPIPS, JSONL and TensorBoard writers, every frame streamed
    (budget 0), all with every launch count at 0 just before and read
    just after.  Then the same twelve steps cached on the card (the same
    bits), every kernel of a step on its own inputs, a repeated step,
    ``render_tiled_batch`` against single
    renders, the writers' files read back, and each layer's time.  Returns
    the launches and the kernels' errors."""
    from collab_splats_tpu_torch.core.cameras import stack_cameras
    from collab_splats_tpu_torch.train import bilateral
    from collab_splats_tpu_torch.train import camera_opt
    from collab_splats_tpu_torch.utils import lpips, writers

    n_vgg = write_vgg16_weights(weights_dir, dev)
    if not lpips.lpips_available():
        raise AssertionError("path 9: vgg16_lpips.npz not found")
    params, alive, cams, cfg = make_scene("bench", dev, sh_degree=3)
    model = rade_gs.RadeGSConfig(
        sh_degree=3, sh_degree_interval=1, background="random",
        render=cfg.render, regularization_from_iter=OPTIONS_REG_FROM)
    with torch.no_grad():
        images = [rade_gs.get_outputs(params, alive, c, 3, model,
                                      training=False)[0]["rgb"]
                  for c in cams]
    init, ialive = perturbed_init(params, dev)
    del params, alive
    logdir = Path(tempfile.mkdtemp(prefix="chip_smoke_writers_"))
    try:
        sinks = writers.make_writers("jsonl,tensorboard", logdir)
        tr = options_trainer(model, cams, images, init, ialive, dev,
                             writers=sinks)
        if not (tr.streaming and tr.images[0].is_pinned()):
            raise AssertionError("path 9: budget 0 did not stream the "
                                 "frames from pinned host memory")
        hist, step_ms = [], []
        reset_counts()
        for _ in range(OPTIONS_STEPS):
            _, t = host_ms(lambda: tr.train(
                1, log_every=10 ** 9, eval_cameras=cams,
                eval_images=images))
            hist.append(tr.history[-1])
            step_ms.append(t)
        launches = counts()
        for w in sinks:
            w.close()
        evals = OPTIONS_STEPS // OPTIONS_EVAL_EVERY
        want = {k: 0 for k in launches}
        want.update(decode=OPTIONS_STEPS + evals,
                    composite=OPTIONS_STEPS + evals,
                    composite_bwd=OPTIONS_STEPS,
                    segment_sum=2 * OPTIONS_STEPS)
        if launches != want:
            raise AssertionError(f"path 9: launches {launches}, expected "
                                 f"{want}")
        for i, h in enumerate(hist):
            if not math.isfinite(h["loss"]) or h["nonfinite_grad"] != 0 \
                    or "tv_loss" not in h:
                raise AssertionError(f"path 9 step {i}: {h}")
            if ("depth_normal_loss" in h) != (i >= OPTIONS_REG_FROM):
                raise AssertionError(f"path 9 step {i}: depth-normal phase")
            if ("eval_lpips" in h) != ((i + 1) % OPTIONS_EVAL_EVERY == 0):
                raise AssertionError(f"path 9 step {i}: eval/LPIPS cadence")
        lp_values = [h["eval_lpips"] for h in hist if "eval_lpips" in h]
        if not all(math.isfinite(v) and v >= 0 for v in lp_values):
            raise AssertionError(f"path 9: LPIPS {lp_values}")
        # The writers' files read back.
        records = [json.loads(x) for x in
                   (logdir / "metrics.jsonl").read_text().splitlines()]
        if [r["step"] for r in records] != list(range(1, OPTIONS_STEPS + 1)) \
                or any(r["loss"] != h["loss"] for r, h in zip(records, hist)):
            raise AssertionError("path 9: metrics.jsonl does not hold the "
                                 "steps' metrics")
        events = writers.read_tfevents_scalars(sinks[1].path)
        tags = {(e["step"], e["tag"]) for e in events}
        if not all((i + 1, "loss") in tags and (i + 1, "tv_loss") in tags
                   for i in range(OPTIONS_STEPS)) or not all(
                (i, "eval_lpips") in tags for i in
                range(OPTIONS_EVAL_EVERY, OPTIONS_STEPS + 1,
                      OPTIONS_EVAL_EVERY)):
            raise AssertionError("path 9: the event file lacks steps")
        streamed = tr.state()
        copy_ms = median_ms(lambda: tr.images[1].to(dev, non_blocking=True))
        pose = tr.camera_params["camera_opt"].detach()
        grid = tr.camera_params["bilateral_grid"].detach()
        check_determinism(tr)
        del tr
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # The same steps with the frames cached on the card: the same bits.
    tr = options_trainer(model, cams, images, init, ialive, dev,
                         budget=4 << 30)
    kin = step_kernel_inputs(tr)
    cached_ms = []
    for _ in range(OPTIONS_STEPS):
        _, t = host_ms(lambda: tr.train(1, log_every=10 ** 9))
        cached_ms.append(t)
    diff = same_trainer_state(streamed, tr.state())
    if diff:
        raise AssertionError(f"path 9: the streamed run and the cached run "
                             f"differ in {diff[:8]}")
    step_trace = traced_totals(lambda: tr.train(1, log_every=10 ** 9),
                               reps=2)
    say(f"main path 9 (trainer options): {OPTIONS_STEPS} steps of the bench "
        f"training scene (1M Gaussians at capacity {ialive.shape[0]}, "
        f"1280x720, sh_degree 3, random background) with camera_opt "
        f"{tuple(pose.shape)} and bilateral_grid {tuple(grid.shape)}, every "
        f"frame streamed from pinned host memory, launches {launches}; "
        f"losses " + ", ".join(f"{h['loss']:.5f}" for h in hist)
        + "; tv_loss " + ", ".join(f"{h['tv_loss']:.3g}" for h in hist)
        + f"; eval LPIPS {[round(v, 6) for v in lp_values]} (seeded VGG16, "
        f"{n_vgg / 1e6:.1f}M parameters); max |pose delta| "
        f"{float(pose.abs().max()):.3g}; the same steps cached on the card "
        f"gave the same bits (parameters, per-camera groups, Adam moments, "
        f"statistics); metrics.jsonl and the event file read back "
        f"({len(records)} records, {len(events)} scalars)")
    stop = tr.config.model.render.stop_threshold
    errs = check_step_kernels(kin, False, "options step", stop)

    # render_tiled_batch over the four cameras against single renders.
    with torch.no_grad():
        p, al = tr.params, tr.alive
        args = (p["means"], p["quats"], gaussians.activated_scales(p),
                gaussians.activated_opacity(p, al),
                rade_gs.compute_colors(p, cams[0], tr.step, model))
        batch = rasterize.render_tiled_batch(*args, stack_cameras(cams),
                                             model.render)
        for i, cam in enumerate(cams):
            single, _ = rasterize.render_tiled(*args, cam, model.render)
            for name, a, b in zip(single._fields, batch, single):
                if not torch.equal(a[i], b):
                    raise AssertionError(f"render_tiled_batch camera {i}: "
                                         f"{name} differs")
        batch_ms = median_ms(lambda: rasterize.render_tiled_batch(
            *args, stack_cameras(cams), model.render), host_clock=True)
    del batch

    # Each layer of the options, alone on the card.
    cam, delta = cams[0], pose[0]
    means = p["means"].detach()
    cov_w = covariance3d(p["quats"].detach(),
                         torch.exp(p["scales"].detach()))
    ct1 = torch.randn(means.shape, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    ct2 = torch.randn(cov_w.shape, generator=torch.Generator(
        device=dev).manual_seed(6), device=dev)

    def pose_term():
        d = delta.clone().requires_grad_(True)
        vm = camera_opt.apply_pose_adjustment(cam, d).viewmat()
        r, t = vm[:3, :3], vm[:3, 3]
        out = torch.sum((means @ r.T + t) * ct1) + torch.sum(
            torch.einsum("ij,njk,lk->nil", r, cov_w, r) * ct2)
        return torch.autograd.grad(out, [d])

    rgb = images[0]
    g0 = grid[0].clone().requires_grad_(True)
    ct3 = torch.randn(rgb.shape, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)

    def grid_fwd():
        return (bilateral.apply_bilateral_grid(g0, rgb),
                bilateral.total_variation_loss(grid))

    def grid_fwd_bwd():
        out, tv = grid_fwd()
        return torch.autograd.grad(torch.sum(out * ct3) + tv, [g0])

    grid_trace = traced_totals(grid_fwd_bwd)
    layers = {
        "pose term (exp_so3, c2w, viewmat, and the backward of the "
        "projection's R_wc, t_wc over the capacity)": median_ms(pose_term),
        "bilateral slice + apply + TV, forward": median_ms(grid_fwd),
        "bilateral forward + backward": median_ms(grid_fwd_bwd),
        "streamed frame copy (pinned host to card, 1280x720x3 float32)":
            copy_ms,
        "LPIPS per eval image (host clock)": median_ms(
            lambda: lpips.lpips(rgb, images[1]), host_clock=True, reps=5),
        "render_tiled_batch of 4 cameras (host clock)": batch_ms,
    }
    del tr
    torch.cuda.empty_cache()

    # The same trainer without the options, cached, for the step time.
    tr = options_trainer(model, cams, images, init, ialive, dev,
                         options=False, budget=4 << 30)
    plain_ms = []
    for _ in range(PLAIN_STEPS):
        _, t = host_ms(lambda: tr.train(1, log_every=10 ** 9))
        plain_ms.append(t)
    del tr
    torch.cuda.empty_cache()
    lp_flops = vgg16_flops(720, 1280) * 2
    lp_ms = layers["LPIPS per eval image (host clock)"]
    nonevals = [t for i, t in enumerate(step_ms)
                if (i + 1) % OPTIONS_EVAL_EVERY]
    eval_ms = [round(t, 4) for i, t in enumerate(step_ms)
               if (i + 1) % OPTIONS_EVAL_EVERY == 0]
    say("path 9 layers (median of 10 CUDA-event timings unless marked, "
        "ms): " + "; ".join(f"{k} {v:.4f}" for k, v in layers.items())
        + f"; LPIPS work {lp_flops / 1e12:.3f} TFLOP a pair (VGG16 at "
        f"1280x720, float32), {lp_flops / lp_ms / 1e9:.1f} TFLOP/s")
    say_totals("path 9 bilateral slice + apply + TV, forward and backward "
               "(1280x720, grid 8x16x16x12)", grid_trace, say)
    say_totals("path 9 options step, cached", step_trace, say)
    say(f"path 9 step (host clock, median (min, max)): options streamed "
        f"{statistics.median(nonevals):.4f} ({min(nonevals):.4f}, "
        f"{max(nonevals):.4f}) over the {len(nonevals)} steps without an "
        f"eval, eval steps {eval_ms}; "
        f"options cached {statistics.median(cached_ms):.4f} "
        f"({min(cached_ms):.4f}, {max(cached_ms):.4f}); no options, cached "
        f"{statistics.median(plain_ms):.4f} ({min(plain_ms):.4f}, "
        f"{max(plain_ms):.4f}) over {PLAIN_STEPS}")
    return {"launches": launches, "errs": errs}


# ------------------------------------------- main path 10: the pipeline
# Splatter on a dataset written from the bench scene: ten orbit cameras at
# 1280x720 (nine train, one eval), 262,144 of its means as the sparse
# cloud, RaDe-GS at capacity 1,048,576 and sh_degree 3 at full resolution.
PIPE_CAMS = 10
PIPE_WIDTH, PIPE_HEIGHT = 1280, 720
PIPE_POINTS = 262_144
PIPE_CAPACITY = 1_048_576
PIPE_FIRST, PIPE_STEPS = 10, 20
PIPE_FEATURE_STEPS = 12
VIEWER_REQUESTS = 5


@contextlib.contextmanager
def timed(owner, name, out):
    """Host ms of every call of ``owner.name`` inside the block, each
    between two synchronises."""
    real = getattr(owner, name)

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return result

    setattr(owner, name, call)
    try:
        yield out
    finally:
        setattr(owner, name, real)


def pipeline_path(dev):
    """Main path 10: the ``Splatter`` pipeline on a bench-scale dataset, in
    a temporary directory outside the checkout (deleted after); the tower
    weights are found through ``COLLAB_SPLATS_WEIGHTS``.  Returns the
    launches and the kernels' errors."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_"))
    try:
        return _pipeline_path(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        extractors._default_extractor.cache_clear()
        torch.cuda.empty_cache()


def _pipeline_path(dev, root):
    import io
    import urllib.request

    from collab_splats_tpu_torch.data import png
    from collab_splats_tpu_torch.data.dataparser import parse_transforms_json
    from collab_splats_tpu_torch.data.ply import read_ply, write_ply
    from collab_splats_tpu_torch.pipeline import cli
    from collab_splats_tpu_torch.pipeline.splatter import Splatter

    stages = {}
    reset_counts()
    # 1. The dataset: the bench scene rendered through the PNG codec.
    params, alive, _, cfg = make_scene("bench", dev)
    (_, _, cams), t = host_ms(lambda: synthetic.write_synthetic_dataset(
        root / "input", n_cams=PIPE_CAMS, width=PIPE_WIDTH,
        height=PIPE_HEIGHT, scene=(params, alive), model_config=cfg,
        device=dev))
    stages["dataset write (10 renders, PNG, PLY)"] = t
    # SfM gives a sparse cloud: keep the first PIPE_POINTS points.
    ply = read_ply(str(root / "input" / "sparse.ply"))
    write_ply(str(root / "input" / "sparse.ply"),
              ply["points"][:PIPE_POINTS], colors=ply["colors"][:PIPE_POINTS])
    scene = parse_transforms_json(root / "input" / "transforms.json",
                                  device=dev)
    if (len(scene.train_cameras), len(scene.eval_cameras)) != (9, 1):
        raise AssertionError("path 10: the split is not 9 train, 1 eval")
    ply = read_ply(str(root / "input" / "sparse.ply"))
    if ply["points"].shape != (PIPE_POINTS, 3):
        raise AssertionError(f"path 10: sparse.ply {ply['points'].shape}")
    with torch.no_grad(), uncounted():
        want = (torch.clamp(render(params, alive, cams[3], cfg)[0]["rgb"],
                            0, 1) * 255).to(torch.uint8).cpu().numpy()
    if not np.array_equal(png.read_png(root / "input" / "images"
                                       / "frame_00003.png"), want):
        raise AssertionError("path 10: frame 3 does not read back to its "
                             "render")
    del params, alive, cams, want

    # 2. RaDe-GS: ten steps, then asked for twenty (a resume), against
    # twenty at once; the first call's step holds every kernel.
    train_kw = dict(capacity=PIPE_CAPACITY, sh_degree=3, num_downscales=0)

    def splatter(name, method="rade-gs"):
        return Splatter({"file_path": str(root / "input"), "method": method,
                         "output_path": str(root / name)}, device=dev)

    a = splatter("a")
    a.preprocess()
    before = counts()
    step_ms, restore_ms = [], []
    with timed(Trainer, "train_one_step", step_ms), \
            timed(Trainer, "restore", restore_ms):
        with captured(tiles, "decode_bin_keys", 1) as dec, \
                captured(batched, "composite_batched_fwd", 1) as fwd, \
                captured(batched, "composite_batched_bwd", 1) as bwd, \
                captured(segsum, "segment_sum_sorted", 2) as seg:
            _, t_first = host_ms(lambda: a.train(max_iterations=PIPE_FIRST,
                                                 **train_kw))
        a._loaded = None
        _, t_resume = host_ms(lambda: a.train(max_iterations=PIPE_STEPS,
                                              **train_kw))
        b = splatter("b")
        b.preprocess()
        b.train(max_iterations=PIPE_STEPS, **train_kw)
    train_launches = {k: v - before[k] for k, v in counts().items()}
    kin = {"decode_args": detached(dec[0]), "fwd_args": detached(fwd[0]),
           "bwd_args": detached(bwd[0]), "step_segsum_args": detached(seg)}
    del dec, fwd, bwd, seg
    n_steps = 2 * PIPE_STEPS
    want = {k: 0 for k in train_launches}
    want.update(decode=n_steps, composite=n_steps, composite_bwd=n_steps,
                segment_sum=2 * n_steps)
    if train_launches != want:
        raise AssertionError(f"path 10 training: launches {train_launches},"
                             f" expected {want}")
    a._loaded = b._loaded = None
    sa, pa, aa, _, _, _ = a.load_model()
    sb, pb, ab, _, _, _ = b.load_model()
    if len(a._runs()) != 1 or (sa, sb) != (PIPE_STEPS, PIPE_STEPS):
        raise AssertionError("path 10: the interrupted run did not resume")
    diff = [k for k in pa if not torch.equal(pa[k], pb[k])]
    if diff or not torch.equal(aa, ab):
        raise AssertionError(f"path 10: the resumed run differs from the "
                             f"uninterrupted one in {diff}")
    stages["first training step"] = step_ms[0]
    stages["training step, median"] = statistics.median(step_ms[1:])
    stages["resume (restore)"] = restore_ms[0]
    stages["resume (train call: restore, 10 steps, save)"] = t_resume
    stages["first train call (init, 10 steps, save)"] = t_first
    with uncounted():
        errs = check_step_kernels(kin, False, "pipeline step",
                                  RenderOptions().stop_threshold)
    del kin, pb, ab, b
    torch.cuda.empty_cache()

    # 3. The mesh, twice: the second call skips.
    res, t = host_ms(lambda: a.mesh(depth_trunc=MESH_DEPTH_TRUNC,
                                    align_floor=True))
    stages["TSDF export (9 cameras)"] = t
    again, t = host_ms(lambda: a.mesh(depth_trunc=MESH_DEPTH_TRUNC,
                                      align_floor=True))
    stages["mesh again (skips)"] = t
    if not (set(again) <= set(res) and {"vertices", "faces"} <= set(again)
            and np.array_equal(again["vertices"], res["vertices"])
            and np.array_equal(again["faces"], res["faces"])):
        raise AssertionError("path 10: the repeated mesh() returned other "
                             "keys or arrays")
    # 4. Loading, aligned cameras, the mesh plot.
    a._loaded = None
    _, t = host_ms(a.load_model)
    stages["load_model"] = t
    aligned = a.load_aligned_cameras()
    T = torch.as_tensor(res["floor_transform"], dtype=torch.float32,
                        device=dev)
    c0 = scene.train_cameras[0].c2w
    if len(aligned) != 9 or not torch.allclose(
            aligned[0].c2w[:3, 3], T[:3, :3] @ c0[:3, 3] + T[:3, 3],
            atol=1e-5):
        raise AssertionError("path 10: aligned cameras")
    img, t = host_ms(lambda: a.plot_mesh(output_fn=root / "mesh.png"))
    stages["plot_mesh (800x600, host)"] = t
    if img.shape != (600, 800, 3) or not np.isfinite(img).all() or \
            png.read_png(root / "mesh.png").shape != (600, 800, 3):
        raise AssertionError("path 10: plot_mesh")
    # 5. The viewer: one request answered with the direct render's image.
    v = a.viewer(port=0, blocking=False)
    try:
        url = (f"http://127.0.0.1:{v._server.server_address[1]}/render?"
               f"theta=0.8&phi=0.5&r=3.0&mode=rgb")
        body = urllib.request.urlopen(url, timeout=120).read()
        with uncounted():
            direct = (np.clip(v.render(0.8, 0.5, 3.0), 0, 1) * 255).astype(
                np.uint8)
            if not np.array_equal(png.decode_png(body), direct) or \
                    direct.shape != (480, 640, 3):
                raise AssertionError("path 10: the viewer's PNG is not the "
                                     "direct render")
            req_ms = []
            for _ in range(VIEWER_REQUESTS):
                t0 = time.perf_counter()
                urllib.request.urlopen(url, timeout=120).read()
                req_ms.append((time.perf_counter() - t0) * 1e3)
            render_ms = median_ms(lambda: v.render(0.8, 0.5, 3.0),
                                  host_clock=True, reps=5)
    finally:
        v.shutdown()
    stages["viewer request 640x480 (render, PNG, HTTP), median"] = \
        statistics.median(req_ms)
    stages["  of which SplatViewer.render"] = render_ms
    n_vertices, n_faces = len(res["vertices"]), len(res["faces"])
    del res, again, aligned, img, a
    torch.cuda.empty_cache()

    # 6. rade-features on the towers' seeded weights: extraction, 12 steps,
    # the mesh and a text query.
    f = splatter("f", "rade-features")
    f.preprocess()
    extract_ms = []
    with timed(feature_dm.FeatureDatamanager, "_setup_features",
               extract_ms):
        _, t = host_ms(lambda: f.train(
            max_iterations=PIPE_FEATURE_STEPS, capacity=PIPE_CAPACITY,
            num_downscales=0, extractors=("clip-vit", "dinov2"),
            feature_type="clip-vit", final_resolution=64))
    stages["feature extraction (9 images, clip-vit and dinov2)"] = \
        extract_ms[0]
    stages["rade-features train call (extraction, 12 steps, save)"] = t
    _, t = host_ms(lambda: f.mesh(depth_trunc=MESH_DEPTH_TRUNC,
                                  align_floor=True))
    stages["rade-features TSDF export with latents"] = t
    sims, t = host_ms(lambda: f.query_mesh(
        ["red disk"], ["object"], output_fn=root / "query.ply"))
    stages["query_mesh"] = t
    with uncounted():
        sims2 = f.query_mesh(["red disk"], ["object"])
    q = read_ply(str(root / "query.ply"))
    if not (np.isfinite(sims).all() and sims.min() >= 0 and sims.max() <= 1
            and np.array_equal(sims, sims2) and "colors" in q
            and len(q["points"]) == len(sims)):
        raise AssertionError("path 10: query_mesh")
    # 7. The CLI on the finished output: every stage skips.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--input", str(root / "input"), "--output",
                       str(root / "a")])
        rc_list = cli.main(["--list-methods"])
    text = out.getvalue()
    skipped = all(m in text for m in ("transforms.json exists",
                                      "checkpoints exist", "mesh exists"))
    if rc != 0 or rc_list != 0 or not skipped or "rade-gs" not in text:
        raise AssertionError(f"path 10: cli returned {rc}/{rc_list}: "
                             f"{text[-400:]}")
    launches = counts()
    for k in ("decode", "composite", "composite_bwd", "segment_sum"):
        if launches[k] == 0:
            raise AssertionError(f"path 10: {k} never launched")
    say(f"main path 10 (Splatter on a bench-scale dataset: 10 cameras at "
        f"1280x720, 9 train and 1 eval, {PIPE_POINTS} points, capacity "
        f"{PIPE_CAPACITY}): launches {launches}; the run asked for "
        f"{PIPE_STEPS} after {PIPE_FIRST} resumed to the bits of "
        f"{PIPE_STEPS} at once; TSDF mesh {n_vertices} vertices, {n_faces} "
        f"faces, the second mesh() skipped; viewer PNG equal to the direct "
        f"render; query similarities in [{sims.min():.4f}, "
        f"{sims.max():.4f}] over {len(sims)} vertices, repeat bit-identical; "
        f"the CLI re-run skipped every stage (rc 0)")
    say("path 10 stages (host clock between synchronises, ms): " + "; ".join(
        f"{k} {v:.4f}" for k, v in stages.items()))
    return {"launches": launches, "errs": errs}


# ------------------------------------ main path 11: multi-device training
# The bench training scene on a (1, 1) mesh under NCCL at world size 1: the
# smoke needs one card, and NCCL refuses two ranks on one GPU, so every
# collective is a copy.  The steps start at step index 3, where every
# SH band is live.
SHARDED_STEPS = 10
SHARDED_REFINE_AT = 5    # the sharded refine after this step
TILE_STEPS = 10
SMALL_CAP_STEPS = 2      # tile-sharded steps at send_cap = shard / 8
SHARDED_STEP0 = 3
SHARDED_PER_STEP = {"decode": 1, "composite": 1, "composite_bwd": 1,
                    "segment_sum": 2}
# The routed step adds two segment sums: the slab gather's backward
# (expand_rows) and the statistics routed back to their shard.
TILE_PER_STEP = dict(SHARDED_PER_STEP, segment_sum=4)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ShardedRun:
    """This process's shard of a training state on a mesh: leaf parameters,
    the alive mask, (Adam, schedule) and the statistics."""

    def __init__(self, mesh, init, alive):
        from collab_splats_tpu_torch.parallel.mesh import shard
        from collab_splats_tpu_torch.train import optim

        self.params = {k: shard(v, mesh).detach().clone().requires_grad_(
            True) for k, v in init.items()}
        self.alive = shard(alive, mesh).clone()
        self.opt = optim.make_optimizer(self.params, optim.RADE_GS_GROUPS)
        self.strat = strategy.init_state(self.alive.shape[0],
                                         device=self.alive.device)

    def bits(self):
        """Copies of every tensor a step writes."""
        moments = [v for st in self.opt[0].state.values()
                   for k, v in sorted(st.items()) if k != "step"]
        return [x.detach().clone() for x in
                [*self.params.values(), *moments, *self.strat]]


def sharded_path(dev):
    """Main path 11: the sharded training step (``parallel/train.py``) at
    the bench training scene's full width (1M Gaussians at capacity
    1,262,144, sh_degree 3, 1280x720, depth-normal on, black background)
    on a (1, 1) mesh under NCCL in this process.  Ten all-gather steps
    with one sharded refine, then ten tile-sharded steps at send_cap =
    shard and two at shard / 8, launch counts per step enforced; the first
    step's loss and gradients against the single-device step, the routed
    step against the all-gather one, a repeated step's bits, kernels 1-4
    on both steps' own inputs, and the step times beside the single-device
    step's.  Returns the launches and the kernels' errors."""
    import torch.distributed as dist

    from collab_splats_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        return _sharded_path(dev, pmesh.make_mesh(1, 1))
    finally:
        dist.destroy_process_group()


def _sharded_path(dev, mesh):
    from collab_splats_tpu_torch.parallel import train as ptrain

    params, alive0, cams, cfg = make_scene("bench", dev, sh_degree=3)
    model = rade_gs.RadeGSConfig(sh_degree=3, sh_degree_interval=1,
                                 background="black", render=cfg.render,
                                 regularization_from_iter=0)
    with torch.no_grad():
        images = [rade_gs.get_outputs(params, alive0, c, 3, model,
                                      training=False)[0]["rgb"]
                  for c in cams]
    init, alive = perturbed_init(params, dev)
    del params, alive0
    cap, width, height = alive.shape[0], cams[0].width, cams[0].height
    shard = cap // mesh.n_gauss
    batches = [(ptrain.CameraBatch(c.K[None], c.c2w[None]), im[None])
               for c, im in zip(cams, images)]

    def make_step(run, **kw):
        return ptrain.make_sharded_train_step(
            mesh, run.opt, model, width, height, cap, reg_active=True, **kw)

    def check_metrics(m, what):
        v = {k: float(x) for k, x in m.items()}
        if not (math.isfinite(v["loss"]) and math.isfinite(v["psnr"])):
            raise AssertionError(f"{what}: {v}")
        return v

    # The first step's loss and gradients against the single-device step
    # (get_outputs(training=True) + get_loss) on camera 0, and the routed
    # step's against the all-gather step's, from the same state.
    run = ShardedRun(mesh, init, alive)
    ag = make_step(run)
    with uncounted():
        m_ag, g_ag = ag.gradients(run.params, run.alive, *batches[0],
                                  SHARDED_STEP0)
        m_tile, _ = make_step(run, tile_sharded=True).gradients(
            run.params, run.alive, *batches[0], SHARDED_STEP0)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in init.items()}
        out, _ = rade_gs.get_outputs(leaves, alive, cams[0], SHARDED_STEP0,
                                     model, training=True,
                                     compute_error_maps=True)
        loss, _ = rade_gs.get_loss(out, images[0], leaves, alive,
                                   SHARDED_STEP0, model, reg_active=True)
        ref = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        loss = float(loss.detach())
    m_ag, m_tile = check_metrics(m_ag, "sharded"), check_metrics(
        m_tile, "tile-sharded")
    if abs(m_ag["loss"] - loss) > 1e-5 * abs(loss):
        raise AssertionError(f"sharded loss {m_ag['loss']} against the "
                             f"single-device {loss}")
    amask = alive.to(torch.float32)
    grad_err, same = 0.0, m_ag["loss"] == loss
    for (k, v), r in zip(leaves.items(), ref):
        r = torch.zeros_like(v) if r is None else \
            r * amask.reshape((-1,) + (1,) * (r.dim() - 1))
        if r.numel():
            grad_err = max(grad_err, assert_grad_close(
                g_ag[k], r, f"sharded gradient of {k}"))
        same = same and torch.equal(g_ag[k], r)
    if abs(m_tile["loss"] - m_ag["loss"]) > 1e-4 * abs(m_ag["loss"]) \
            or m_tile["spilled"] != m_ag["spilled"]:
        raise AssertionError(f"tile-sharded {m_tile} against all-gather "
                             f"{m_ag}")
    say(f"parity sharded step (1x1 mesh, NCCL, bench training scene camera "
        f"0, step index {SHARDED_STEP0}): loss {m_ag['loss']:.7f} against "
        f"the single-device {loss:.7f}; pre-Adam gradients of "
        f"{len(leaves)} tensors within the gradient tolerance (max abs err "
        f"{grad_err:.3g}); loss and gradients bit-identical: {same}; "
        f"tile-sharded loss {m_tile['loss']:.7f} (rel "
        f"{abs(m_tile['loss'] / m_ag['loss'] - 1):.3g}), spilled "
        f"{int(m_tile['spilled'])} = {int(m_ag['spilled'])}")
    del leaves, out, loss, ref, g_ag
    kin = kernel_inputs_of(lambda: ag(run.params, run.alive, run.strat,
                                      *batches[0], SHARDED_STEP0))
    del run, ag
    torch.cuda.empty_cache()

    # Main path 11: all-gather steps with the sharded refine, counted.
    run = ShardedRun(mesh, init, alive)
    ag = make_step(run)
    hist, ag_ms, first = [], [], None
    reset_counts()
    for i in range(SHARDED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, run.strat, m = ag(run.params, run.alive, run.strat,
                             *batches[i % len(batches)], SHARDED_STEP0 + i)
        hist.append(check_metrics(m, f"sharded step {i}"))
        ag_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = run.bits()
        if i + 1 == SHARDED_REFINE_AT:
            # As on path 2: the 1% of seen rows with the largest mean
            # gradient densify on this random scene.
            st = run.strat
            seen = run.alive & (st.count > 0)
            avg = (st.grad_accum / torch.clamp(st.count, min=1.0))[seen]
            scfg = strategy.StrategyConfig(
                warmup_length=4, refine_every=REFINE_EVERY,
                densify_grad_thresh=float(torch.quantile(avg, 0.99)))
            refine = ptrain.make_sharded_refine_step(mesh, scfg)
            n_before = int(run.alive.sum())
            _, run.alive, run.strat, rc = refine(
                run.params, run.alive, run.opt, run.strat, seed=1000 + i,
                screen_cull=True)
            rc = [int(x) for x in rc]
            n_after = int(run.alive.sum())
            if not all(rc[:3]):
                raise AssertionError(f"sharded refine: dup, split, cull, "
                                     f"dropped {rc}")
    torch.cuda.synchronize()
    ag_launches = counts()
    want = {k: SHARDED_PER_STEP.get(k, 0) * SHARDED_STEPS
            for k in ag_launches}
    if ag_launches != want:
        raise AssertionError(f"path 11 (all-gather): launches {ag_launches}"
                             f", expected {want}")

    # Tile-sharded steps from the same state, counted.
    tile = make_step(run, tile_sharded=True)
    small = make_step(run, tile_sharded=True, send_cap=shard // 8)
    thist = []
    reset_counts()
    for i in range(TILE_STEPS + SMALL_CAP_STEPS):
        step = tile if i < TILE_STEPS else small
        _, run.strat, m = step(run.params, run.alive, run.strat,
                               *batches[i % len(batches)],
                               SHARDED_STEP0 + SHARDED_STEPS + i)
        thist.append(check_metrics(m, f"tile-sharded step {i}"))
    torch.cuda.synchronize()
    tile_launches = counts()
    n_tile = TILE_STEPS + SMALL_CAP_STEPS
    want = {k: TILE_PER_STEP.get(k, 0) * n_tile for k in tile_launches}
    if tile_launches != want:
        raise AssertionError(f"path 11 (tile-sharded): launches "
                             f"{tile_launches}, expected {want}")
    if not all(h["spilled"] > thist[TILE_STEPS - 1]["spilled"]
               for h in thist[TILE_STEPS:]):
        raise AssertionError(f"send_cap {shard // 8}: no routing spill "
                             f"{[h['spilled'] for h in thist]}")

    # A repeated first step: the same bits.
    run2 = ShardedRun(mesh, init, alive)
    with uncounted():
        _, run2.strat, _ = make_step(run2)(run2.params, run2.alive,
                                           run2.strat, *batches[0],
                                           SHARDED_STEP0)
    again = run2.bits()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("a repeated sharded step gave other bits")
    del first, again
    tile2 = make_step(run2, tile_sharded=True)
    tkin = kernel_inputs_of(lambda: tile2(run2.params, run2.alive,
                                          run2.strat, *batches[0],
                                          SHARDED_STEP0))
    del run2
    torch.cuda.empty_cache()
    stop = model.render.stop_threshold
    errs = check_step_kernels(kin, False, "sharded step", stop)
    terrs = check_step_kernels(tkin, False, "tile-sharded step", stop)
    errs = {k: max(v, terrs.get(k, 0.0)) for k, v in errs.items()}
    del kin, tkin

    # Step times (CUDA events, steady state over 2 and 10 steps) beside the
    # single-device trainer's on the same scene, and a trace.
    with uncounted():
        def one(step):
            return lambda: step(run.params, run.alive, run.strat,
                                *batches[0], SHARDED_STEP0)

        ag_s = profiling.timed(one(ag))
        tile_s = profiling.timed(one(tile))
        trace = traced_totals(one(ag))
        del run, ag, tile, small
        torch.cuda.empty_cache()
        tr = Trainer(TrainerConfig(
            model=model, max_iterations=1000, seed=0,
            strategy=strategy.StrategyConfig(warmup_length=10 ** 7)),
            cams, images, init, alive, device=dev)
        single_s = profiling.timed(tr.train_one_step)
        del tr
    torch.cuda.empty_cache()
    say(f"main path 11 (multi-device, 1x1 mesh under NCCL at world size "
        f"1): {SHARDED_STEPS} all-gather steps of the bench training scene "
        f"(capacity {cap}, {width}x{height}, sh_degree 3, depth-normal on), "
        f"launches "
        f"{ag_launches}; losses " + ", ".join(f"{h['loss']:.5f}"
                                              for h in hist)
        + f"; sharded refine after step {SHARDED_REFINE_AT}: dup {rc[0]}, "
        f"split {rc[1]}, cull {rc[2]}, dropped {rc[3]}, Gaussians "
        f"{n_before} -> {n_after}; "
        f"{TILE_STEPS} tile-sharded steps at send_cap {shard} and "
        f"{SMALL_CAP_STEPS} at {shard // 8}, launches {tile_launches}; "
        f"losses " + ", ".join(f"{h['loss']:.5f}" for h in thist)
        + "; spilled " + ", ".join(str(int(h["spilled"])) for h in thist)
        + "; a repeated step gave the same bits (parameters, Adam moments, "
        "statistics)")
    say(f"path 11 step (host clock, median (min, max) over "
        f"{SHARDED_STEPS}): all-gather {statistics.median(ag_ms):.4f} "
        f"({min(ag_ms):.4f}, {max(ag_ms):.4f}, the refine not included); "
        f"steady state (utils/profiling.timed, CUDA events, (t(10) - t(2)) "
        f"/ 8, camera 0): all-gather {ag_s * 1e3:.4f} ms, tile-sharded "
        f"{tile_s * 1e3:.4f} ms, single-device trainer step "
        f"{single_s * 1e3:.4f} ms")
    say_totals("path 11 all-gather step", trace, say)
    return {"launches": {k: ag_launches[k] + tile_launches[k]
                         for k in ag_launches}, "errs": errs}


# ------------------------- main path 12: the golden renderer, analytic fit
GOLDEN_N, GOLDEN_SIZE = 4096, 512
ANALYTIC_VIEWS, ANALYTIC_WIDTH, ANALYTIC_HEIGHT = 8, 640, 480
ANALYTIC_POINTS = 100_000
ANALYTIC_STEPS = 300
# tests/test_render.py:153-158.
GOLDEN_ATOL = {"color": 2e-5, "alpha": 2e-5, "normal": 2e-5, "depth": 2e-4,
               "median_depth": 2e-4}


def golden_path(dev):
    """Main path 12: ``render_golden`` on the card at a seeded scene that
    neither tiled renderer spills (4,096 Gaussians at 512x512), both tiled
    renderers held against it; then the analytic scene (``data/
    analytic.py``: eight 640x480 views ray-traced on the host, 100,000
    seed points, ``init_from_points``) fitted by the trainer for 300 steps,
    whose mean training-view PSNR must rise by 3 dB, kernels 1-4 held
    against their plain versions on one fit step's own inputs, and a TSDF
    mesh's accuracy and completeness against the true surfaces (printed).
    Returns the launches and the kernels' max abs errors."""
    from collab_splats_tpu_torch.core.golden import render_golden
    from collab_splats_tpu_torch.core.sh import sh0_to_rgb
    from collab_splats_tpu_torch.data import analytic
    from collab_splats_tpu_torch.train import losses
    from collab_splats_tpu_torch.utils.metrics import (calculate_accuracy,
                                                       calculate_completeness)

    params, _, cams, cfg = make_scene("flagship", dev, n=GOLDEN_N,
                                      width=GOLDEN_SIZE, height=GOLDEN_SIZE)
    opts = dataclasses.replace(cfg.render, tile_capacity=512,
                               max_intersections=1 << 18)
    args = (params["means"], params["quats"], torch.exp(params["scales"]),
            torch.sigmoid(params["opacities"][:, 0]),
            sh0_to_rgb(params["features_dc"]))
    cam = cams[0]
    reset_counts()
    with torch.no_grad():
        tiled = {"xla": rasterize.render_tiled(*args, cam, opts)[0],
                 "pallas": rasterize.render_tiled_pallas(*args, cam,
                                                         opts)[0]}
        gold = render_golden(*args, None, cam, opts)
        golden_ms = timings(lambda: render_golden(*args, None, cam, opts),
                            host_clock=True, reps=3)
    errs = {}
    for backend, out in tiled.items():
        if int(out.spilled) != 0:
            raise AssertionError(f"golden scene: {backend} spilled "
                                 f"{int(out.spilled)}")
        for name, atol in GOLDEN_ATOL.items():
            err = float((getattr(out, name) - getattr(gold, name)).abs()
                        .max())
            if not err <= atol:
                raise AssertionError(f"render_tiled ({backend}) {name} off "
                                     f"the golden by {err} > {atol}")
            errs[f"{backend} {name}"] = err
    cover = float((gold.alpha > 0).float().mean())
    say(f"main path 12 (golden renderer): render_golden of {GOLDEN_N} "
        f"Gaussians at {GOLDEN_SIZE}x{GOLDEN_SIZE} (covered share "
        f"{cover:.4f}) in {statistics.median(golden_ms):.1f} ms (host "
        f"clock, median of {len(golden_ms)}); spilled 0 in both tiled "
        f"renderers; max abs err against it: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()))

    # The analytic scene, fitted.
    scene = analytic.default_scene(seed=7)
    acams = synthetic.orbit_cameras(
        ANALYTIC_VIEWS, radius=3.2, width=ANALYTIC_WIDTH,
        height=ANALYTIC_HEIGHT, focal=0.9 * ANALYTIC_WIDTH, device=dev)
    renders, trace_ms = [], []
    for c in acams:
        t0 = time.perf_counter()
        renders.append(analytic.render_analytic(scene, c))
        trace_ms.append((time.perf_counter() - t0) * 1e3)
    cloud = analytic.seed_points_from_views(scene, acams, renders,
                                            ANALYTIC_POINTS, seed=0)
    (init, ialive), init_ms = host_ms(lambda: gaussians.init_from_points(
        cloud["points"], np.clip(cloud["colors"], 0.02, 0.98),
        torch.Generator(device=dev).manual_seed(0), sh_degree=3,
        device=dev))
    images = [torch.from_numpy(r["rgb"]).to(dev) for r in renders]
    model = rade_gs.RadeGSConfig(
        sh_degree=3, sh_degree_interval=100, background="black",
        render=RenderOptions(rasterize_mode="antialiased"),
        use_depth_normal_loss=False)
    tr = Trainer(TrainerConfig(
        model=model, max_iterations=ANALYTIC_STEPS,
        strategy=strategy.StrategyConfig(warmup_length=10 ** 7)),
        acams, images, init, ialive, device=dev)

    @torch.no_grad()
    def view_psnr():
        return [float(losses.psnr(rade_gs.get_outputs(
            tr.params, tr.alive, c, tr.step, model, training=False)[0]["rgb"],
            im)) for c, im in zip(acams, images)]

    before = view_psnr()
    with uncounted():
        kin = step_kernel_inputs(tr)
    t0 = time.perf_counter()
    for _ in range(ANALYTIC_STEPS):
        last = tr.train_one_step()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after = view_psnr()
    gain = statistics.mean(after) - statistics.mean(before)
    say(f"main path 12 (analytic fit): default_scene(seed=7), "
        f"{ANALYTIC_VIEWS} views at {ANALYTIC_WIDTH}x{ANALYTIC_HEIGHT} "
        f"ray-traced on the host in {statistics.median(trace_ms):.1f} ms a "
        f"view (median), {ANALYTIC_POINTS} seed points, init_from_points "
        f"{init_ms:.1f} ms; {ANALYTIC_STEPS} steps in {fit_s:.2f} s, last "
        f"loss {last['loss']:.5f}, {last['num_gaussians']} Gaussians; mean "
        f"training-view PSNR {statistics.mean(before):.2f} -> "
        f"{statistics.mean(after):.2f} dB ({gain:+.2f})")
    if not gain >= 3.0:
        raise AssertionError(f"analytic fit: PSNR rose by {gain:.2f} dB")
    launches = counts()
    renders_done = 2 * ANALYTIC_VIEWS
    want = {k: 0 for k in launches}
    want.update(decode=ANALYTIC_STEPS + renders_done + 2,
                composite=ANALYTIC_STEPS + renders_done + 1,
                composite_bwd=ANALYTIC_STEPS,
                segment_sum=2 * ANALYTIC_STEPS, composite_tiles=1)
    if launches != want:
        raise AssertionError(f"path 12: launches {launches}, expected "
                             f"{want}")
    # One fit step traced, then the trainer's state put back.
    with uncounted():
        snap = tr.state()
        trace = traced_totals(tr.train_one_step)
        tr.load_state(snap)
        del tr.history[-4:], snap
    say_totals("path 12 analytic fit step", trace, say)

    # The TSDF mesh against the true surfaces (printed, no gate).
    ex = exporters.TSDFFusionExporter(
        tr.params, tr.alive, model, exporters.TSDFExporterConfig(
            voxel_size=0.02, sdf_trunc=0.06, depth_trunc=12.0, max_dim=256,
            align_floor=False, min_component_fraction=0.0))
    res, mesh_ms = host_ms(lambda: ex.main(acams))
    verts = res["vertices"]
    surface = analytic.sample_gt_surface(scene, 200_000, seed=0)
    say(f"path 12 TSDF mesh of the fit ({ANALYTIC_VIEWS} views, voxel "
        f"0.02, max_dim 256): {len(verts)} vertices in {mesh_ms:.0f} ms; "
        f"accuracy (90th percentile distance to the true surface) "
        f"{calculate_accuracy(verts, surface):.4f}, completeness (share of "
        f"true-surface samples within 0.05) "
        f"{calculate_completeness(verts, surface):.2f}%")
    errs = check_step_kernels(kin, False, "path 12 analytic step",
                              model.render.stop_threshold)
    del tr, ex, images, kin
    torch.cuda.empty_cache()
    return {"launches": launches, "errs": errs}


# ------------------------------- main path 13: the at-scale training run
SCALE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_scale"
# The reference run's width (640x360, 64 views, sh_degree 3, exact
# binning, 30,000 seed points, capacity 262,144) on a shortened schedule
# that crosses every phase switch but the end of splitting: downscale
# 4 -> 2 -> 1 at steps 1,000 and 2,000, SH degrees 1-3 at 1,000-3,000,
# refines every 100 steps from 600, the opacity reset at 3,100, the
# depth-normal phase from 2,200.
SCALE_STEPS = 3200
SCALE_FLAGS = ["--analytic-gt", "--sh-degree", "3", "--exact-binning",
               "--seed-points", "30000", "--capacity", "262144",
               "--res-schedule", "1000", "--reg-from", "2200",
               "--save-every", "1000"]
SCALE_RESUME_FROM = 2000   # the resumed leg crosses the phase flip at 2,200
SCALE_KILL_AT = 2400
SCALE_MESH_AT = 3000
SCALE_FEATURE_STEPS = 500
SCALE_PER_STEP = {"decode": 1, "composite": 1, "composite_bwd": 1,
                  "segment_sum": 2}


def scale_launches(steps, renders, skipped=0):
    """Launches of ``steps`` train steps (``skipped`` of them non-finite,
    whose statistics are not summed) and ``renders`` evaluation renders."""
    want = {k: 0 for k in counts()}
    want.update({k: v * steps for k, v in SCALE_PER_STEP.items()})
    want["segment_sum"] -= skipped
    want["decode"] += renders
    want["composite"] += renders
    return want


def counted_leg(what, want_fn, fn):
    """``fn()`` with every launch count at 0 just before and read just
    after; the counts must be ``want_fn(result)``."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = counts()
    want = want_fn(out)
    if got != want:
        raise AssertionError(f"path 13 {what}: launches {got}, expected "
                             f"{want}")
    return out, got


def spread(ms):
    q = statistics.quantiles(ms, n=10)
    return (f"median {statistics.median(ms):.4f} ms (p10 {q[0]:.4f}, p90 "
            f"{q[-1]:.4f}, min {min(ms):.4f}, max {max(ms):.4f}, "
            f"{len(ms)} steps)")


def history_rows(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def stage_totals(times):
    """'name total s (calls)' for each stage that ran."""
    return "; ".join(f"{k} {sum(t):.4f} s ({len(t)})"
                     for k, t in times.items())


def scale_path(dev):
    """Main path 13: the port's ``scripts/`` entry points in this process
    at the reference run's full width.  ``scale_train.run`` trains the
    shortened schedule (3,200 steps, a checkpoint every 1,000, an 8-view
    eval every 500); a fresh trainer resumes from the step-2,000
    checkpoint with the same flags and is stopped after step 2,400, as a
    kill would, and its 400 rows must equal the first run's bit for bit
    (every key but ``wall_s``); ``evaluate_mesh`` meshes the step-3,000
    checkpoint against the scene's true surfaces; a 500-step
    ``--features`` leg on the same traced frames is checkpointed and
    ``run_chain`` meshes and queries it.  Kernels 1-4 are held against
    their plain versions on one step of the resumed trainer.  Returns the
    launches and the kernels' max abs errors."""
    from collab_splats_tpu_torch.scripts import (feature_chain_eval,
                                                 mesh_eval, scale_train)

    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    extractors._default_extractor.cache_clear()   # the offline towers
    run_dir, feat_dir = SCALE_DIR / "run", SCALE_DIR / "features"
    flags = SCALE_FLAGS + ["--steps", str(SCALE_STEPS), "--out",
                           str(run_dir)]
    args = scale_train.parse_args(flags)
    frames, trace_ms = host_ms(lambda: scale_train.make_frames(args, dev))

    def quiet(_):
        """The scripts' progress lines; path 13 prints its own."""

    def eval_renders(n_evals):
        return n_evals * args.eval_cams + len(frames.cameras[::8])

    # The shortened schedule.
    res, main_launches = counted_leg(
        "training", lambda r: scale_launches(
            SCALE_STEPS, eval_renders(len(r.evals)),
            r.summary["nonfinite_grad_steps"]),
        lambda: scale_train.run(args, frames=frames, log=quiet))
    summ = res.summary
    hist = history_rows(run_dir / "history.jsonl")
    if [h["step"] for h in hist] != list(range(1, SCALE_STEPS + 1)):
        raise AssertionError(f"path 13: history steps are not 1.."
                             f"{SCALE_STEPS}")
    bad = [h["step"] for h in hist
           if not all(math.isfinite(v) for v in h.values())]
    if bad or summ["nonfinite_grad_steps"]:
        raise AssertionError(f"path 13: non-finite rows {bad[:5]}, "
                             f"{summ['nonfinite_grad_steps']} non-finite "
                             f"steps")
    refines = [h["step"] for h in hist if "refine_cull" in h]
    reg = [h["step"] for h in hist if "depth_normal_loss" in h]
    if not reg or reg[0] != args.reg_from + 1 or not refines:
        raise AssertionError(f"path 13: depth-normal rows from {reg[:1]}, "
                             f"{len(refines)} refines")
    psnrs = [e["eval_psnr"] for e in res.evals]
    if not summ["final_psnr_mean"] > psnrs[0]:
        raise AssertionError(f"path 13: eval PSNR {psnrs[0]:.2f} -> final "
                             f"{summ['final_psnr_mean']:.2f} dB")
    ms, r, g = res.step_ms, args.res_schedule, args.reg_from
    say(f"main path 13 (scale_train, {args.width}x{args.height}, "
        f"{len(frames.cameras)} ray-traced views in {trace_ms / 1e3:.1f} s, "
        f"{args.seed_points} seeds, capacity {args.capacity}, "
        f"{SCALE_STEPS} steps): launches {main_launches}; step (CUDA "
        f"events) {spread(ms)}; at downscale 4 "
        f"{statistics.median(ms[:r]):.4f}, 2 "
        f"{statistics.median(ms[r:2 * r]):.4f}, 1 "
        f"{statistics.median(ms[2 * r:g]):.4f}, 1 with depth-normal "
        f"{statistics.median(ms[g:]):.4f} ms (medians)")
    say("path 13 evals (step: 8-view PSNR dB / SSIM / N): " + ", ".join(
        f"{e['step']}: {e['eval_psnr']:.2f} / {e['eval_ssim']:.4f} / "
        f"{e['num_gaussians']}" for e in res.evals)
        + f"; final {summ['final_psnr_mean']:.4f} dB / SSIM "
        f"{summ['final_ssim_mean']:.4f}; peak N {summ['peak_gaussians']}, "
        f"final {summ['final_gaussians']}, max spill "
        f"{summ['max_spill_seen']}, non-finite steps "
        f"{summ['nonfinite_grad_steps']}, {len(refines)} refines, "
        f"depth-normal from step {int(reg[0])}")
    wall = [h["wall_s"] * 1e3 for h in hist]
    outside = (summ["wall_clock_s"] - sum(res.eval_s) - sum(res.save_s)
               ) * 1e3 - sum(wall)
    say(f"path 13 loop: step on the host clock median "
        f"{statistics.median(wall):.4f} ms (CUDA events "
        f"{statistics.median(ms):.4f}); outside the steps, evals and saves "
        f"(history rows, the final eval) {outside / len(wall):.4f} ms a "
        f"step")
    say(f"path 13 stages (host clock): eval of 8 views "
        f"{statistics.median(res.eval_s) * 1e3:.1f} ms (median of "
        f"{len(res.eval_s)}), checkpoint save "
        f"{statistics.median(res.save_s):.2f} s (median of "
        f"{len(res.save_s)}), whole run {summ['wall_clock_s']:.1f} s")
    del res
    torch.cuda.empty_cache()

    # A fresh trainer resumed from step 2,000 and stopped after 2,400.
    rargs = scale_train.parse_args(flags + [
        "--resume", str(run_dir / f"step-{SCALE_RESUME_FROM:08d}.ckpt.npz")])
    steps = SCALE_KILL_AT - SCALE_RESUME_FROM
    rres, resume_launches = counted_leg(
        "resume", lambda r: scale_launches(steps, 0),
        lambda: scale_train.run(rargs, frames=frames,
                                stop_after=SCALE_KILL_AT, log=quiet))
    first = history_rows(run_dir / "history_prekill.jsonl")
    if first != hist:
        raise AssertionError("path 13: history_prekill.jsonl is not the "
                             "first run's history")
    again = history_rows(run_dir / "history.jsonl")
    strip = [{k: v for k, v in h.items() if k != "wall_s"} for h in again]
    ref = [{k: v for k, v in h.items() if k != "wall_s"}
           for h in hist[:SCALE_KILL_AT]]
    differ = [r["step"] for r, g in zip(ref, strip) if r != g]
    if len(again) != SCALE_KILL_AT or differ:
        raise AssertionError(f"path 13 resume: {len(again)} rows, steps "
                             f"{differ[:5]} differ from the first run")
    say(f"path 13 resume: a fresh trainer from step {SCALE_RESUME_FROM} "
        f"stopped after {SCALE_KILL_AT} (launches {resume_launches}): "
        f"{steps} rows bit-identical to the first run's (every key but "
        f"wall_s), across the depth-normal flip at {args.reg_from}; step "
        f"(CUDA events) "
        f"{spread(rres.step_ms)}")
    tr = rres.trainer
    with uncounted():
        kin = step_kernel_inputs(tr)
        # One step traced (the card's busy and idle time), then the
        # trainer's state put back.
        snap = tr.state()
        trace = traced_totals(tr.train_one_step)
        tr.load_state(snap)
        del tr.history[-4:], snap
    say_totals("path 13 at-scale step (step 2401, depth-normal on)",
               trace, say)
    errs = check_step_kernels(kin, False, "path 13 at-scale step",
                              tr.config.model.render.stop_threshold)
    del rres, tr, kin
    torch.cuda.empty_cache()

    # The step-3,000 checkpoint meshed against the true surfaces.
    mesh_stages = {}
    mesh_ckpt = run_dir / f"step-{SCALE_MESH_AT:08d}.ckpt.npz"
    (payload, mesh_ms), mesh_launches = counted_leg(
        "mesh eval", lambda _: scale_launches(0, 32),
        lambda: host_ms(lambda: mesh_eval.evaluate_mesh(
            mesh_ckpt, device=dev, stage_times=mesh_stages)))
    if not (payload["n_vertices"] > 0
            and math.isfinite(payload["accuracy_p90"])):
        raise AssertionError(f"path 13 mesh eval: {payload}")
    say(f"path 13 mesh eval (step {payload['step']}, 32 views, voxel "
        f"{payload['voxel_size']}): "
        f"{payload['n_vertices']} vertices, accuracy p90 "
        f"{payload['accuracy_p90']:.4f}, completeness "
        f"{payload['completeness_pct']:.2f}% in {mesh_ms / 1e3:.2f} s ("
        + stage_totals(mesh_stages) + ")")

    # The rade-features leg on the same frames, then the chain.
    fargs = scale_train.parse_args(SCALE_FLAGS + [
        "--features", "--steps", str(SCALE_FEATURE_STEPS), "--save-every",
        str(SCALE_FEATURE_STEPS), "--out", str(feat_dir)])
    fres, feat_launches = counted_leg(
        "features", lambda r: scale_launches(
            SCALE_FEATURE_STEPS, eval_renders(len(r.evals)),
            r.summary["nonfinite_grad_steps"]),
        lambda: scale_train.run(fargs, frames=frames, log=quiet))
    fsumm = fres.summary
    fhist = history_rows(feat_dir / "history.jsonl")
    floss = [h["features_loss"] for h in fhist]
    q = len(floss) // 4
    head, tail = statistics.mean(floss[:q]), statistics.mean(floss[-q:])
    if fsumm["nonfinite_grad_steps"] or not tail < head:
        raise AssertionError(f"path 13 features: {fsumm}, features_loss "
                             f"{floss[:3]} ... {floss[-3:]}")
    say(f"path 13 features ({SCALE_FEATURE_STEPS} steps, clip-vit and "
        f"dinov2 maps of the 64 frames, 13 latents): launches "
        f"{feat_launches}; step (CUDA events) {spread(fres.step_ms)}; "
        f"final PSNR {fsumm['final_psnr_mean']:.2f} dB; features_loss "
        f"{head:.6f} -> {tail:.6f} (means of the first and last {q} "
        f"steps)")
    del fres
    torch.cuda.empty_cache()
    chain_stages = {}
    (stats, chain_ms), chain_launches = counted_leg(
        "feature chain", lambda _: scale_launches(0, 32),
        lambda: host_ms(lambda: feature_chain_eval.run_chain(
            feat_dir, device=dev, stage_times=chain_stages)))
    if not (stats["n_vertices"] > 0 and stats["latent_dim"] == 13
            and 0.0 <= stats["similarity_min"] <= stats["similarity_max"]
            <= 1.0):
        raise AssertionError(f"path 13 feature chain: {stats}")
    say(f"path 13 feature chain (step {stats['step']}): "
        f"{stats['n_vertices']} vertices, similarity min "
        f"{stats['similarity_min']:.4g}, max {stats['similarity_max']:.4g}, "
        f"mean {stats['similarity_mean']:.4g} in {chain_ms / 1e3:.2f} s ("
        + stage_totals(chain_stages) + ")")
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    launches = {k: sum(p[k] for p in (main_launches, resume_launches,
                                      mesh_launches, feat_launches,
                                      chain_launches))
                for k in main_launches}
    return {"launches": launches, "errs": errs}


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    logs = build.build_all()
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    say(f"built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")

    scenes = {"flagship": make_scene("flagship", dev),
              "bench": make_scene("bench", dev)}
    inputs = {name: parity(name, sc) for name, sc in scenes.items()}
    check_decode_plans(dev)
    tiles_in = {name: tiles_parity(name, sc) for name, sc in scenes.items()}
    if not sum(early for _, _, early in tiles_in.values()):
        raise AssertionError("composite_tiles: no tile ended early at "
                             "stop_threshold 1e-4")
    edge_errs = check_edge_cases(dev)
    for name, sc in scenes.items():
        check_pallas_vs_xla(name, sc)
    seg_err = check_segsum(
        render(*scenes["bench"][:2], scenes["bench"][2][0],
               scenes["bench"][3])[1].bins, scenes["bench"][1].shape[0])
    say(f"parity bench: segment_sum max abs err {seg_err:.3g} against its "
        f"plain version (M={3600 * 512}, D=15, N=1000000), repeat "
        f"bit-identical")
    seg_err = max(seg_err, check_segsum_streams(dev))
    for backend in ("xla", "pallas"):
        reference_check(dev, backend)
        train_reference_check(dev, backend)
    # A global buffer that is not a multiple of the per-tile compositor's
    # chunk, so neither is the aligned matrix's width.
    reference_check(dev, "pallas", max_intersections=30_000)

    # Main paths 1 and 3, the forward render with each compositor, with
    # every launch count at 0 just before each.
    pallas_scenes = {name: (p, a, cams, pallas_config(cfg))
                     for name, (p, a, cams, cfg) in scenes.items()}
    for backend, path_scenes, per_render in (
            ("xla", scenes, {"decode": 1, "composite": 1}),
            ("pallas", pallas_scenes, {"decode": 1, "composite_tiles": 1})):
        reset_counts()
        with captured(rasterize, "pack_intersections") as packs:
            outs = {name: [render(p, a, cam, cfg)[0] for cam in cams]
                    for name, (p, a, cams, cfg) in path_scenes.items()}
        torch.cuda.synchronize()
        render_launches = counts()
        if packs:
            raise AssertionError(f"render ({backend}): {len(packs)} calls of "
                                 "pack_intersections")
        n_renders = sum(len(o) for o in outs.values())
        want = {k: per_render.get(k, 0) * n_renders for k in render_launches}
        if render_launches != want:
            raise AssertionError(f"render ({backend}): launches "
                                 f"{render_launches}, expected {want}")
        say(f"main path (render, {backend}): {n_renders} renders, launches "
            f"{render_launches}, no pack_intersections call")
        for name, (params, _, cams, _) in path_scenes.items():
            for i, (out, cam) in enumerate(zip(outs[name], cams)):
                check_outputs(f"{name} camera {i} ({backend})", out, cam)
            spilled = [int(o["spilled"]) for o in outs[name]]
            cover = [round(float((o["accumulation"] > 0).float().mean()), 4)
                     for o in outs[name]]
            say(f"{name} ({backend}): {len(cams)} camera(s) at "
                f"{cams[0].width}x{cams[0].height}, "
                f"{params['means'].shape[0]} Gaussians: spilled {spilled}, "
                f"covered pixel share {cover}")
        del outs

    # The train step's layers and backward kernels, at the main path's
    # shapes, on the trainer's first state (put back afterwards).
    tr = training_setup(dev)
    start = tr.state()
    seg_errs = [check_segsum_step(tr)]
    tr.step = 3   # every SH band live
    tlayers, kin = train_layer_times(tr)
    tr.load_state(start)
    # Kernel 3 against its plain version on the step's own window rows,
    # mask, banked prefix and the loss's cotangent.
    step_bwd_err = check_composite_bwd_args(kin["bwd_args"], "train step")
    say(f"parity train step: composite_bwd on the step's inputs and the "
        f"loss's cotangent (T={kin['g'].shape[0]}, K={kin['g'].shape[1]}) "
        f"max abs err {step_bwd_err:.3g} (gradient tolerance per column "
        f"group, masked slots 0, repeat bit-identical)")

    # Main path 2, the training step at the bench scene's width.
    refine_at = 2 * REFINE_EVERY
    hist, step_ms, launches = train_main_path(tr, TRAIN_STEPS, refine_at)
    check_training(hist, launches, refine_at, REG_FROM, {
        "decode": 1, "composite": 1, "composite_bwd": 1, "segment_sum": 2})
    say(f"main path (training): {len(hist)} steps of the bench scene "
        f"(1M Gaussians, 1280x720, sh_degree 3, random background), "
        f"launches {launches}; losses "
        + ", ".join(f"{h['loss']:.5f}" for h in hist)
        + f"; PSNR {hist[0]['psnr']:.2f} -> {hist[-1]['psnr']:.2f} dB")
    r = hist[refine_at - 1]
    say(f"refine after step {refine_at}: dup {r['refine_dup']}, split "
        f"{r['refine_split']}, cull {r['refine_cull']}, dropped "
        f"{r['refine_dropped']}; Gaussians {r['num_gaussians']} -> "
        f"{hist[-1]['num_gaussians']}, capacity {tr.alive.shape[0]}; "
        f"opacity reset after step {REFINE_EVERY}; depth-normal loss from "
        f"step {REG_FROM}")
    say(f"train step (host clock, bench scene): median "
        f"{statistics.median(step_ms):.4f} ms over {len(step_ms)} steps, min "
        f"{min(step_ms):.4f}, max {max(step_ms):.4f}")
    check_determinism(tr)
    # Kernel 4 again at the grown capacity of the steps after the refine.
    seg_errs.append(check_segsum_step(tr))
    refine_ms = refine_times(tr)
    say(f"refine pass alone (strategy.refine at capacity "
        f"{tr.alive.shape[0]}, host clock, median of {REPS}): "
        f"{statistics.median(refine_ms):.4f} ms, min {min(refine_ms):.4f}, "
        f"max {max(refine_ms):.4f}; the train step that ran the refine took "
        f"{step_ms[refine_at - 1]:.4f} ms (host clock)")
    fitting_run(dev)
    del tr, start
    torch.cuda.empty_cache()

    # Main path 4, the training step with the per-tile compositor, at the
    # same width; its layers and kernel 6's inputs first, on the trainer's
    # first state.
    tr = training_setup(dev, "pallas", PALLAS_REFINE_EVERY, PALLAS_REG_FROM)
    start = tr.state()
    tr.step = 3
    player, pkin = train_layer_times(tr)
    tr.load_state(start)
    # Kernels 5 and 6 against their plain versions on the step's own
    # inputs, kernel 6 with the loss's cotangent.
    step_errs = {"composite_tiles_bwd": check_tiles_bwd(
        pkin["bwd_args"], "pallas train step"),
        "composite_bwd": step_bwd_err}
    step_errs["composite_tiles"], step_nch, _ = check_tiles_fwd(
        pkin["tiles"], tr.config.model.render.stop_threshold)
    if not torch.equal(step_nch, pkin["nchunks"]):
        raise AssertionError("composite_tiles: the step's nchunks differ "
                             "from a second forward's")
    say(f"parity pallas train step (bench scene camera 0, step inputs): "
        f"composite_tiles max abs err {step_errs['composite_tiles']:.3g} "
        f"(nchunks equal), composite_tiles_bwd on the loss's cotangent max "
        f"abs err {step_errs['composite_tiles_bwd']:.3g} (gradient "
        f"tolerance per column group, repeat bit-identical); "
        f"{int(pkin['nchunks'].sum())} of "
        f"{int(chunks_walked(pkin['tiles']).sum())} chunks run")
    prefine_at = PALLAS_REFINE_AT
    phist, pstep_ms, plaunches = train_main_path(tr, PALLAS_STEPS,
                                                 prefine_at)
    check_training(phist, plaunches, prefine_at, PALLAS_REG_FROM, {
        "decode": 1, "composite_tiles": 1, "composite_tiles_bwd": 1,
        "segment_sum": 2})
    say(f"main path (training, pallas): {len(phist)} steps of the bench "
        f"scene (1M Gaussians, 1280x720, sh_degree 3, random background, "
        f"stop_threshold {tr.config.model.render.stop_threshold}), launches "
        f"{plaunches}; losses "
        + ", ".join(f"{h['loss']:.5f}" for h in phist)
        + f"; PSNR {phist[0]['psnr']:.2f} -> {phist[-1]['psnr']:.2f} dB")
    r = phist[prefine_at - 1]
    say(f"refine (pallas) after step {prefine_at}: dup {r['refine_dup']}, "
        f"split {r['refine_split']}, cull {r['refine_cull']}, dropped "
        f"{r['refine_dropped']}; Gaussians {r['num_gaussians']} -> "
        f"{phist[-1]['num_gaussians']}, capacity {tr.alive.shape[0]}; "
        f"opacity reset after step {PALLAS_REFINE_EVERY}; depth-normal loss "
        f"from step {PALLAS_REG_FROM}")
    say(f"train step (pallas, host clock, bench scene): median "
        f"{statistics.median(pstep_ms):.4f} ms over {len(pstep_ms)} steps, "
        f"min {min(pstep_ms):.4f}, max {max(pstep_ms):.4f}")
    check_determinism(tr)
    del tr, start
    torch.cuda.empty_cache()

    # Main paths 5 and 6, rade-features training with each compositor,
    # path 5 killed and resumed; then progressive resolution.
    fdata = feature_data(dev)
    fx = feature_step_path(fdata, dev, "xla")
    fp = feature_step_path(fdata, dev, "pallas")
    prog_launches = progressive_phase(fdata, dev)
    torch.cuda.empty_cache()

    # Main path 7, mesh extraction from path 5's checkpoint (deleted
    # after); then the meshing paths on small scenes against the CPU.
    mesh_launches, vertex_latents, ckpt_decoder = mesh_path(
        dev, fx["ckpt"], fdata.cams, fdata.render)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    mesh_small_scenes(dev, scenes)

    # Main path 8, the feature towers: extraction from path 5's images,
    # training on the maps, the text query over path 7's mesh, segmentation
    # and grouping.
    # Then main paths 9 (the trainer's options, LPIPS on VGG16 weights
    # written beside the towers') and 10 (the Splatter pipeline, with the
    # towers for rade-features), while the weights directory exists.
    with tower_weights(dev) as (wdir, weights):
        tw = tower_path(fdata, dev, vertex_latents, ckpt_decoder, wdir,
                        weights)
        del fdata, vertex_latents, ckpt_decoder
        extractors._default_extractor.cache_clear()
        torch.cuda.empty_cache()
        opt = options_path(dev, wdir)
        torch.cuda.empty_cache()
        pipe = pipeline_path(dev)
    torch.cuda.empty_cache()

    # Main path 11, multi-device training on a 1x1 mesh under NCCL; main
    # path 12, the golden renderer and the analytic fit.
    sharded = sharded_path(dev)
    torch.cuda.empty_cache()
    golden = golden_path(dev)
    torch.cuda.empty_cache()
    # Main path 13, the at-scale training run and its evaluations through
    # the entry points of collab_splats_tpu_torch/scripts/.
    scale = scale_path(dev)
    torch.cuda.empty_cache()
    for backend, f in (("xla", fx), ("pallas", fp)):
        say(f"layers of the rade-features {backend} train step, bench scene "
            f"camera 0 (median of {REPS}, ms): " + ", ".join(
                f"{k} {v:.4f}" for k, v in f["layers"].items()))
    # Per element of the kernels' rows, the feature steps' widths against
    # the RaDe-GS steps' (V = 6, C = 3, D = 15).
    elems = []
    for label, kk, lay in (("RaDe-GS", kin, tlayers),
                           ("rade-features", fx["kin"], fx["layers"])):
        g, mask, ntx = kk["fwd_args"][:3]
        t, k, d = g.shape
        m, dseg = kk["segsum_args"][2].shape
        elems.append(f"{label} V={d - 9}: " + "; ".join([
            per_element("kernel 2", median_ms(
                lambda: batched.composite_batched_fwd(g, mask, ntx, TS,
                                                      NEAR)), t * k * d),
            per_element("kernel 3", lay["composite_bwd kernel"], t * k * d),
            per_element(f"kernel 4 at D={dseg}", lay["segment_sum kernel"],
                        m * dseg)]))
    stop = RenderOptions().stop_threshold
    for label, kk, lay in (("RaDe-GS", pkin, player),
                           ("rade-features", fp["kin"], fp["layers"])):
        ti, nch = kk["tiles"], kk["nchunks"]
        slots = walked_slots(ti, nch) * ti.per_gauss.shape[1]
        m, dseg = kk["segsum_args"][2].shape
        elems.append(f"{label} C={ti.n_color}: " + "; ".join([
            per_element("kernel 5", median_ms(
                lambda: composite.composite_tiles_fwd(*ti.fwd_args(stop))),
                slots),
            per_element("kernel 6", lay["composite_tiles_bwd kernel"], slots),
            per_element(f"kernel 4 at D={dseg}", lay["segment_sum kernel"],
                        m * dseg)]))
    say("kernels per element of their rows on the train steps' own inputs "
        "(median of 10; rows T*K*(9+V), walked slots * Dp, M*D): "
        + " | ".join(elems))

    records = {}
    for name, (params, alive, cams, cfg) in scenes.items():
        plan, g, mask, ntx, errs = inputs[name]
        turn = iter(range(10 ** 6))
        rec = {
            "decode_ms": median_ms(
                lambda: binning_kernel.decode_bin_keys(*decode_args(plan))),
            "decode_plain_ms": median_ms(
                lambda: binning_kernel.decode_keys_plain(*decode_args(plan))),
            "composite_ms": median_ms(
                lambda: batched.composite_batched_fwd(g, mask, ntx, TS,
                                                      NEAR)),
            "composite_banked_ms": median_ms(
                lambda: batched.composite_batched_fwd(g, mask, ntx, TS, NEAR,
                                                      bank_prefix=True)),
            "composite_plain_ms": median_ms(
                lambda: compositing.fused_forward(g, mask, ntx, TS, NEAR,
                                                  tile_chunk=256)),
            "render_ms": timings(
                lambda: render(params, alive, cams[next(turn) % len(cams)],
                               cfg),
                host_clock=True, reps=RENDER_REPS),
            "decode_bound": decode_bound(plan),
            "composite_bound": composite_bound(g, mask, ntx),
            "errs": errs,
        }
        # Kernel 5 at the main path's C = 3 and stop_threshold.
        ti, terrs, _ = tiles_in[name]
        stop = pallas_scenes[name][3].render.stop_threshold
        _, nch = composite.composite_tiles_fwd(*ti.fwd_args(stop))
        pcfg = pallas_scenes[name][3]
        rec.update({
            "composite_tiles_ms": median_ms(
                lambda: composite.composite_tiles_fwd(*ti.fwd_args(stop))),
            "composite_tiles_plain_ms": median_ms(
                lambda: composite.composite_tiles_fwd_gather_plain(
                    *ti.fwd_args(stop))),
            "composite_tiles_bound": composite_tiles_bound(ti, nch),
            "pallas_render_ms": timings(
                lambda: render(params, alive, cams[next(turn) % len(cams)],
                               pcfg),
                host_clock=True, reps=RENDER_REPS),
        })
        rec["errs"].update(terrs)
        records[name] = rec
        layers = layer_times(params, alive, cams[0], cfg)
        say(f"layers {name} camera 0 (median of {REPS}, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in layers.items())
            + f"; sum {sum(layers.values()):.4f}")
        say(f"time {name} (median of {REPS}): decode kernel "
            f"{rec['decode_ms']:.4f} ms, plain {rec['decode_plain_ms']:.4f} "
            f"ms, bound {rec['decode_bound'][0]:.4f} ms by "
            f"{rec['decode_bound'][1]}; composite kernel "
            f"{rec['composite_ms']:.4f} ms ({rec['composite_banked_ms']:.4f} "
            f"ms banking the prefix), plain "
            f"{rec['composite_plain_ms']:.4f} ms, bound "
            f"{rec['composite_bound'][0]:.4f} ms by "
            f"{rec['composite_bound'][1]}")
        culled, live_share = cull_shares(g, mask, ntx)
        say(f"composite {name} (V=6): of the (pixel, masked-in slot) pairs "
            f"{100 * culled:.2f}% are decided by the cull without exp, "
            f"{100 * (1 - culled):.2f}% run exp, {100 * live_share:.2f}% are "
            f"live")
        players = pallas_layer_times(params, alive, cams[0],
                                     pallas_scenes[name][3])
        say(f"layers {name} camera 0, pallas (median of {REPS}, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in players.items())
            + f"; sum {sum(players.values()):.4f}")
        say(f"time {name}: composite_tiles kernel (C=3, stop "
            f"{stop}, median of {REPS}) {rec['composite_tiles_ms']:.4f} ms, "
            f"plain {rec['composite_tiles_plain_ms']:.4f} ms, bound "
            f"{rec['composite_tiles_bound'][0]:.4f} ms by "
            f"{rec['composite_tiles_bound'][1]}; {int(nch.sum())} of "
            f"{int(chunks_walked(ti).sum())} chunks run")
        for backend, key in (("xla", "render_ms"),
                             ("pallas", "pallas_render_ms")):
            r = rec[key]
            say(f"render {name} ({backend}, host clock, {len(r)} calls "
                f"cycling the cameras): median {statistics.median(r):.4f} ms "
                f"per camera, min {min(r):.4f}, max {max(r):.4f}")

    say(f"layers of the train step, bench scene camera 0 (median of {REPS}, "
        f"ms): " + ", ".join(f"{k} {v:.4f}" for k, v in tlayers.items()))
    bargs, sargs = kin["bwd_args"], kin["segsum_args"]
    m, d = sargs[2].shape
    b = records["bench"]
    b.update({
        "composite_bwd_ms": tlayers["composite_bwd kernel"],
        "composite_bwd_plain_ms": median_ms(
            lambda: compositing.fused_backward(
                bargs[0], bargs[1], bargs[7], bargs[8], *bargs[3:7],
                kin["ntx"], TS, NEAR),
            reps=PLAIN_REPS),
        "composite_bwd_bound": composite_bwd_bound(kin["g"], kin["mask"],
                                                   kin["ntx"]),
        "segment_sum_ms": tlayers["segment_sum kernel"],
        "segment_sum_plain_ms": median_ms(
            lambda: segsum_kernel.segment_sum_plain(*sargs)),
        "segment_sum_library_ms": median_ms(
            lambda: torch.zeros((sargs[3], d), device=dev).index_add_(
                0, kin["idx"].long(), sargs[2])),
        "segment_sum_bound": segsum_bound(m, d, sargs[3]),
    })
    s2 = kin["segsum2_args"]
    seg2 = {
        "ms": median_ms(lambda: segsum_kernel.segment_sum_sorted(*s2)),
        "library_ms": median_ms(
            lambda: torch.zeros((s2[3], 2), device=dev).index_add_(
                0, kin["idx"].long(), s2[2])),
        "bound": segsum_bound(m, 2, s2[3]),
    }
    live, masked_in = live_warp_slots(kin["g"], kin["mask"], kin["ntx"])
    all_slots = kin["g"].shape[0] * kin["g"].shape[1] * TS * TS // 32
    say(f"time train step kernels (bench scene, median of {REPS}; plain "
        f"backward of {PLAIN_REPS}): composite_bwd kernel "
        f"{b['composite_bwd_ms']:.4f} ms, plain "
        f"{b['composite_bwd_plain_ms']:.4f} ms, bound "
        f"{b['composite_bwd_bound'][0]:.4f} ms by "
        f"{b['composite_bwd_bound'][1]}; segment_sum kernel "
        f"{b['segment_sum_ms']:.4f} ms, plain "
        f"{b['segment_sum_plain_ms']:.4f} ms, index_add_ "
        f"{b['segment_sum_library_ms']:.4f} ms, bound "
        f"{b['segment_sum_bound'][0]:.4f} ms by {b['segment_sum_bound'][1]} "
        f"(M={m}, D={d}, N={sargs[3]}); at the statistic's D=2 rows "
        f"segment_sum kernel {seg2['ms']:.4f} ms, index_add_ "
        f"{seg2['library_ms']:.4f} ms, bound {seg2['bound'][0]:.4f} ms by "
        f"{seg2['bound'][1]}")
    say(f"composite_bwd at the train step: {live} of {all_slots} (warp, "
        f"window slot) pairs ({100 * live / all_slots:.2f}%) have a pixel "
        f"whose alpha passes the cutoff ({100 * live / masked_in:.2f}% of "
        f"the {masked_in} masked-in pairs); only those run the gradient and "
        f"the butterfly")
    say(f"layers of the pallas train step, bench scene camera 0 (median of "
        f"{REPS}, ms): " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in player.items()))
    bt = pkin["bwd_args"]
    b.update({
        "composite_tiles_bwd_ms": player["composite_tiles_bwd kernel"],
        "composite_tiles_bwd_plain_ms": median_ms(
            lambda: composite.composite_tiles_bwd_gather_plain(*bt)),
        "composite_tiles_bwd_bound": composite_tiles_bwd_bound(
            pkin["tiles"], pkin["nchunks"]),
    })
    say(f"time pallas train step kernel (bench scene): composite_tiles_bwd "
        f"kernel {b['composite_tiles_bwd_ms']:.4f} ms, plain "
        f"{b['composite_tiles_bwd_plain_ms']:.4f} ms (median of {REPS} "
        f"each), bound "
        f"{b['composite_tiles_bwd_bound'][0]:.4f} ms by "
        f"{b['composite_tiles_bwd_bound'][1]} "
        f"({int(pkin['nchunks'].sum())} chunks)")
    tlive, tall = tiles_live_warp_slots(pkin["tiles"], pkin["nchunks"])
    say(f"composite_tiles_bwd at the pallas train step: {tlive} of {tall} "
        f"(warp, slot) pairs inside the segments of the chunks run "
        f"({100 * tlive / tall:.2f}%) have a pixel of the warp's 8x4 block "
        f"whose alpha passes the cutoff; only those run the gradient and "
        f"the butterfly")
    longest, share = long_rows_share(pkin["idx"], pkin["segsum_args"][3])
    say(f"segment_sum at the pallas train step: longest segment {longest} "
        f"rows, {100 * share:.4f}% of the rows in segments over "
        f"{segsum_kernel.LONG_ROWS}")

    # The kernels line, at the bench scene's shapes (the RaDe-GS steps);
    # launches summed over the training main paths, mesh extraction, the
    # feature towers, the trainer's options, the pipeline, multi-device
    # training and the golden and analytic path.
    path_launches = {"path 2 (xla)": launches, "path 4 (pallas)": plaunches,
                     "path 5 (rade-features, xla)": fx["launches"],
                     "path 6 (rade-features, pallas)": fp["launches"],
                     "progressive resolution": prog_launches,
                     "path 7 (mesh extraction)": mesh_launches,
                     "path 8 (feature towers)": tw["launches"],
                     "path 9 (trainer options)": opt["launches"],
                     "path 10 (pipeline)": pipe["launches"],
                     "path 11 (multi-device)": sharded["launches"],
                     "path 12 (golden, analytic fit)": golden["launches"],
                     "path 13 (at-scale run)": scale["launches"]}
    say("launches per training, meshing, tower, options, pipeline, "
        "multi-device, golden and at-scale main path: " + "; ".join(
        f"{k}: { {n: v for n, v in p.items() if v} }"
        for k, p in path_launches.items()))
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in launches}
    feature_errs = [fx["errs"], fp["errs"], tw["errs"], opt["errs"],
                    pipe["errs"], sharded["errs"], golden["errs"],
                    scale["errs"]]
    kernels = []
    for key, name, src, tpu, lib in (
            ("decode", "decode_bin_keys", "binning_kernel.cu",
             "binning_kernel.py:172", None),
            ("composite", "composite_batched_fwd", "batched_fwd.cu",
             "batched.py:176", None),
            ("composite_bwd", "composite_batched_bwd", "batched_bwd.cu",
             "batched_bwd.py:187", None),
            ("segment_sum", "segment_sum_sorted", "segsum_kernel.cu",
             "segsum_kernel.py:99", "segment_sum_library_ms"),
            ("composite_tiles", "composite_tiles_fwd", "composite_fwd.cu",
             "composite.py:557", None),
            ("composite_tiles_bwd", "composite_tiles_bwd_call",
             "composite_bwd.cu", "composite.py:624", None)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"collab_splats_tpu_torch/csrc/{src}",
            "replaces": f"collab_splats_tpu/ops/pallas/{tpu}",
            "launches": launches[key],
            "max_abs_err": (max(seg_err, *seg_errs) if key == "segment_sum"
                            else max(step_errs.get(key, 0.0),
                                     edge_errs.get(key, 0.0),
                                     *(e.get(key, 0.0) for e in feature_errs),
                                     *(r["errs"][key]
                                       for r in records.values()))),
            "ms": b[f"{key}_ms"], "plain_ms": b[f"{key}_plain_ms"],
            "bound_ms": b[f"{key}_bound"][0],
            "bound_by": b[f"{key}_bound"][1],
            "library_ms": b[lib] if lib else None,
        })
    say(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(f"card: {CARD}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the port's two CUDA kernels from ``collab_splats_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the
forward render (``models/rade_gs.py::get_outputs``) on the flagship scene
(20,000 Gaussians, 512x512) and on the bench scene (1M Gaussians,
1280x720, four orbit cameras), checks what comes out, and prints timings.

Run it from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Any failure raises and exits non-zero.  The last line of a successful run
is ``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches on the main path, its error against its plain version,
and its times beside its bound.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from collab_splats_tpu_torch.core import compositing
from collab_splats_tpu_torch.core.options import RenderOptions
from collab_splats_tpu_torch.core.projection import project_gaussians
from collab_splats_tpu_torch.data import synthetic
from collab_splats_tpu_torch.models import gaussians, rade_gs
from collab_splats_tpu_torch.ops import rasterize, tiles
from collab_splats_tpu_torch.ops.cuda import batched, binning_kernel, build

# One H100 SXM at its full 700 W limit (NVIDIA's data sheet): the rates
# the bounds below are computed from.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TOL = dict(rtol=1e-5, atol=1e-5)
REPS = 10
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


def median_ms(fn, host_clock=False):
    return statistics.median(timings(fn, host_clock))


def make_scene(name: str, dev, n=None, width=None, height=None):
    """(params, alive, cameras, config) of the flagship or the bench scene,
    with random weights drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(0)
    if name == "flagship":
        # __graft_entry__.py::_flagship_scene.
        n, width, height = n or 20_000, width or 512, height or 512
        params = synthetic.random_gaussian_params(gen, n, extent=1.0,
                                                  device=dev)
        cams = synthetic.orbit_cameras(1, radius=3.0, width=width,
                                       height=height, focal=1.2 * width,
                                       device=dev)
        opts = RenderOptions(rasterize_mode="antialiased")
    else:
        # bench.py's configuration: 1M Gaussians at 1280x720.
        n, width, height = n or 1_000_000, width or 1280, height or 720
        params = synthetic.random_gaussian_params(
            gen, n, extent=1.5, scale_range=(0.002, 0.006), device=dev)
        cams = synthetic.orbit_cameras(4, radius=3.0, width=width,
                                       height=height, focal=float(width),
                                       device=dev)
        opts = RenderOptions(rasterize_mode="antialiased", tile_capacity=512,
                             max_intersections=1 << 21, exact_binning=False)
    cfg = rade_gs.RadeGSConfig(sh_degree=0, background="black", render=opts)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    return params, alive, cams, cfg


def render(params, alive, cam, cfg):
    return rade_gs.get_outputs(params, alive, cam, 0, cfg, training=False)


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


def check_decode(plan) -> float:
    """The kernel's whole (key, gid) stream against the plain version's:
    bit-exact.  Returns the max abs difference (0)."""
    key, gid = binning_kernel.decode_bin_keys(*decode_args(plan))
    ref_key, ref_gid = binning_kernel.decode_keys_plain(*decode_args(plan))
    err = max(int((key - ref_key).abs().max()),
              int((gid - ref_gid).abs().max()))
    if err:
        bad = int(((key != ref_key) | (gid != ref_gid)).sum())
        raise AssertionError(f"decode: {bad} slots differ from the plain "
                             "version")
    return float(err)


def check_composite(g, mask, ntx) -> float:
    """The kernel's outputs against the plain version's, within rtol/atol
    1e-5.  Returns the max abs difference."""
    got = batched.composite_batched_fwd(g, mask, ntx, TS, NEAR)
    ref = compositing.fused_forward(g, mask, ntx, TS, NEAR, tile_chunk=256)
    for name, a, b in zip(("out_v", "alpha", "depth_acc", "median"), got,
                          ref):
        torch.testing.assert_close(a, b, msg=f"composite {name}", **TOL)
    hit = got[1] > 0
    say(f"  composite V={g.shape[2] - 9}: med_idx differs from the plain "
        f"version at {int((got[4] != ref[4])[hit].sum())} of "
        f"{int(hit.sum())} covered pixels")
    return max(float((a - b).abs().max()) for a, b in zip(got[:4], ref))


def parity(name, scene):
    """Each kernel against its plain version at the scene's shapes; returns
    the main path's decode plan, its V = 6 window rows, mask and ntx, and
    the max abs errors."""
    params, alive, cams, cfg = scene
    plans, g19, mask, ntx = kernel_inputs(params, alive, cams[0], cfg)
    g6 = g19[..., :15].contiguous()
    errs = {
        "decode": max(check_decode(p) for p in plans.values()),
        "composite": max(check_composite(g6, mask, ntx),
                         check_composite(g19, mask, ntx)),
    }
    say(f"parity {name}: decode bit-exact with exact and quantized ranks "
        f"({plans[True].m_cap} slots); composite max abs err "
        f"{errs['composite']:.3g} at V=6 and V=19 (T={g6.shape[0]}, "
        f"K={g6.shape[1]})")
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
    live = 0
    for s in range(0, t, 64):
        gg = g[s:s + 64]
        up, vp = compositing.pixel_centers(
            torch.arange(s, s + gg.shape[0], device=g.device), ntx, TS)
        alpha = compositing.splat_alpha(
            up[:, :, None] - gg[:, None, :, 0],
            vp[:, :, None] - gg[:, None, :, 1],
            gg[:, None, :, 2:5], gg[:, None, :, 8],
            mask[s:s + 64, None, :] > 0)
        live += int((alpha > 0).sum())
    return bound(nbytes, 23 * masked + (11 + 2 * v) * live)


def layer_times(params, alive, cam, cfg):
    """Median ms of each layer of one render, called in the order
    ``ops/rasterize.py::render_tiled`` calls them."""
    opts = cfg.render
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

    proj = project()
    op = opac * proj.compensation
    colors = rade_gs.compute_colors(params, cam, 0, cfg)
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
            lambda: rade_gs.compute_colors(params, cam, 0, cfg)),
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


def reference_check(dev):
    """The whole render on the card (kernels) against the same small scene
    rendered on the CPU (plain versions), within rtol/atol 1e-5."""
    params, alive, cams, cfg = make_scene("flagship", dev, n=3000,
                                          width=128, height=96)
    cam = cams[0]
    got, _ = render(params, alive, cam, cfg)
    cpu_cam = dataclasses.replace(cam, K=cam.K.cpu(), c2w=cam.c2w.cpu())
    ref, _ = render({k: v.cpu() for k, v in params.items()}, alive.cpu(),
                    cpu_cam, cfg)
    for k in KEYS:
        torch.testing.assert_close(got[k].cpu(), ref[k],
                                   msg=f"card vs CPU {k}", **TOL)
    err = max(float((got[k].cpu() - ref[k]).abs().max()) for k in KEYS)
    say(f"reference: 3000 Gaussians at 128x96, card (kernels) vs CPU "
        f"(plain versions): max abs err {err:.3g}")


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    dev = torch.device("cuda")

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
    reference_check(dev)

    # The main path, with every launch count at 0 just before it.
    binning_kernel.launches = 0
    batched.launches = 0
    outs = {name: [render(p, a, cam, cfg)[0] for cam in cams]
            for name, (p, a, cams, cfg) in scenes.items()}
    torch.cuda.synchronize()
    launches = {"decode": binning_kernel.launches,
                "composite": batched.launches}
    n_renders = sum(len(o) for o in outs.values())
    for kernel, n in launches.items():
        if n != n_renders:
            raise AssertionError(f"{kernel}: {n} launches in {n_renders} "
                                 "renders of the main path")
    say(f"main path: {n_renders} renders, launches {launches}")
    for name, (params, _, cams, _) in scenes.items():
        for i, (out, cam) in enumerate(zip(outs[name], cams)):
            check_outputs(f"{name} camera {i}", out, cam)
        spilled = [int(o["spilled"]) for o in outs[name]]
        cover = [round(float((o["accumulation"] > 0).float().mean()), 4)
                 for o in outs[name]]
        say(f"{name}: {len(cams)} camera(s) at {cams[0].width}x"
            f"{cams[0].height}, {params['means'].shape[0]} Gaussians: "
            f"spilled {spilled}, covered pixel share {cover}")

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
        records[name] = rec
        layers = layer_times(params, alive, cams[0], cfg)
        say(f"layers {name} camera 0 (median of {REPS}, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in layers.items())
            + f"; sum {sum(layers.values()):.4f}")
        say(f"time {name} (median of {REPS}): decode kernel "
            f"{rec['decode_ms']:.4f} ms, plain {rec['decode_plain_ms']:.4f} "
            f"ms, bound {rec['decode_bound'][0]:.4f} ms by "
            f"{rec['decode_bound'][1]}; composite kernel "
            f"{rec['composite_ms']:.4f} ms, plain "
            f"{rec['composite_plain_ms']:.4f} ms, bound "
            f"{rec['composite_bound'][0]:.4f} ms by "
            f"{rec['composite_bound'][1]}")
        r = rec["render_ms"]
        say(f"render {name} (host clock, {len(r)} calls cycling the "
            f"cameras): median {statistics.median(r):.4f} ms per camera, "
            f"min {min(r):.4f}, max {max(r):.4f}")

    # The kernels line, at the bench scene's shapes (the full-size path).
    b = records["bench"]
    kernels = []
    for key, name, src, tpu in (
            ("decode", "decode_bin_keys", "binning_kernel.cu",
             "binning_kernel.py:172"),
            ("composite", "composite_batched_fwd", "batched_fwd.cu",
             "batched.py:176")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"collab_splats_tpu_torch/csrc/{src}",
            "replaces": f"collab_splats_tpu/ops/pallas/{tpu}",
            "launches": launches[key],
            "max_abs_err": max(r["errs"][key] for r in records.values()),
            "ms": b[f"{key}_ms"], "plain_ms": b[f"{key}_plain_ms"],
            "bound_ms": b[f"{key}_bound"][0],
            "bound_by": b[f"{key}_bound"][1], "library_ms": None,
        })
    print(f"card: {CARD}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

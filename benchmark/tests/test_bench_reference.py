"""The plain reference against the program at a tiny size on the CPU,
where the program runs its kernels' plain versions."""

import numpy as np
import pytest
import torch

from benchlib import scene
from reference import render as R
from reference import train as RT
from reference.precision import Products, round_tf32

OPTS = {"tile_size": 16, "eps2d": 0.3, "near_plane": 0.01,
        "far_plane": 1e10, "rasterize_mode": "classic",
        "normalize_depth": True, "radius_clip": 0.0,
        "max_intersections": None, "tile_capacity": None,
        "ellipse_cull": True, "exact_binning": True}


def tiny_scene(seed=3, n=400, cap=512, sh=3):
    params = scene.gaussian_table(seed, n, cap, sh, 0, 1.0, (0.02, 0.08),
                                  "cpu", perturbed=True)
    alive = scene.alive_mask(n, cap, "cpu")
    rig = scene.orbit_rig(2, 3.0, 64, 48, 64.0)
    return params, alive, rig


def program_camera(r):
    from collab_splats_tpu_torch.core.cameras import make_camera

    return make_camera(float(r["K"][0, 0]), float(r["K"][1, 1]),
                       float(r["K"][0, 2]), float(r["K"][1, 2]), r["width"],
                       r["height"], r["c2w"], device="cpu")


def test_projection_equals_the_program():
    from collab_splats_tpu_torch.core.projection import project_gaussians

    params, alive, rig = tiny_scene()
    cam = program_camera(rig[0])
    opac = torch.sigmoid(params["opacities"][:, 0]) * alive
    scales = torch.exp(params["scales"])
    got = R.project(params["means"], params["quats"], scales, opac,
                    R.camera(rig[0], "cpu"), OPTS, Products())
    want = project_gaussians(params["means"], params["quats"], scales,
                             cam.viewmat(), cam.K, 64, 48, opacities=opac)
    for f in ("mean2d", "depth", "conic", "plane", "normal", "valid",
              "radius_xy", "compensation"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("cap, m_cap", [(None, None), (8, 700)])
def test_binning_equals_the_program(cap, m_cap):
    """Windows, masks and the spill count, with and without the global
    budget and the per-tile window cutting."""
    from collab_splats_tpu_torch.core.options import RenderOptions
    from collab_splats_tpu_torch.ops.tiles import bin_gaussians

    params, alive, rig = tiny_scene()
    opts = dict(OPTS, tile_capacity=cap, max_intersections=m_cap)
    opac = torch.sigmoid(params["opacities"][:, 0]) * alive
    proj = R.project(params["means"], params["quats"],
                     torch.exp(params["scales"]), opac,
                     R.camera(rig[1], "cpu"), opts, Products())
    proj = proj._replace(valid=proj.valid & alive)
    got = R.bin_tiles(proj, opac, 64, 48, opts)
    want = bin_gaussians(proj, 64, 48, RenderOptions(
        tile_capacity=cap, max_intersections=m_cap), opacities=opac)
    assert torch.equal(got.tile_mask, want.tile_mask)
    assert torch.equal(got.tile_gauss[got.tile_mask],
                       want.tile_gauss[want.tile_mask].long())
    assert got.spilled == int(want.spilled)
    if cap:
        assert got.spilled > 0


def test_render_matches_the_program():
    from collab_splats_tpu_torch.models import rade_gs

    params, alive, rig = tiny_scene()
    model = {"render": OPTS, "sh_degree": 3, "sh_degree_interval": 1000,
             "latent_dim": 0}
    cfg = rade_gs.RadeGSConfig(sh_degree=3)
    for r in rig:
        out, _ = rade_gs.get_outputs(params, alive, program_camera(r), 0, cfg,
                                     training=False)
        ref = RT.render_rgb(params, alive, R.camera(r, "cpu"), 0, model,
                            Products())
        torch.testing.assert_close(ref, out["rgb"], rtol=0, atol=1e-6)


def test_round_tf32():
    x = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -12,
                      1 + 3 * 2.0 ** -12, -(1 + 3 * 2.0 ** -12),
                      float("inf"), 0.0])
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1.0, 1 + 2.0 ** -10,
                         -(1 + 2.0 ** -10), float("inf"), 0.0])
    assert torch.equal(round_tf32(x), want)


def test_tf32_products_pass_the_gradient_through():
    a = torch.randn(4, 3, requires_grad=True)
    b = torch.randn(3, 2)
    Products(tf32=True).matmul(a, b).sum().backward()
    # The gradient flows straight through a's rounding, times b as the
    # forward product read it.
    torch.testing.assert_close(a.grad, round_tf32(b).sum(1).expand(4, 3))


def test_adam_matches_torch():
    """The reference's Adam against ``torch.optim.Adam`` from a count of
    15,000 with zero moments, for a decaying group."""
    p = torch.randn(5, 3)
    g = [torch.randn(5, 3) for _ in range(3)]
    spec = {"lr": 1.6e-4, "lr_final": 1.6e-6, "max_steps": 30000,
            "warmup_steps": 0, "lr_pre_warmup": 1e-8, "eps": 1e-15}
    ref = {"means": p.clone()}
    adam = RT.Adam({"means": spec}, (0.9, 0.999), 15000)
    t = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([t], lr=RT.lr_at(spec, 15000), eps=1e-15)
    opt.state[t] = {"step": torch.tensor(15000.0),
                    "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)}
    for j, gj in enumerate(g):
        adam.step(ref, {"means": gj})
        for group in opt.param_groups:
            group["lr"] = RT.lr_at(spec, 15000 + j)
        t.grad = gj
        opt.step()
    np.testing.assert_allclose(ref["means"].numpy(), t.detach().numpy(),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("step", [15100, 15099])
def test_the_cull_equals_the_program(step):
    """The reference's cull-only refine against ``strategy.refine`` as the
    trainer calls it past the densification window, on a table with
    faint rows and, after the scale cull's switch-on, oversized ones."""
    from collab_splats_tpu_torch.train import strategy

    params, alive, _ = tiny_scene()
    params["scales"][:7] = np.log(0.8)
    cfg = strategy.StrategyConfig()
    s = {k: getattr(cfg, k) for k in (
        "warmup_length", "refine_every", "reset_alpha_every",
        "stop_split_at", "stop_screen_size_at", "cull_alpha_thresh",
        "cull_scale_thresh", "continue_cull_post_densification")}
    trainer = {"max_iterations": 30000, "scene_scale": 1.0}
    got = RT.refine_alive(params, alive, step, s, trainer)
    if not cfg.is_refine_step(step):
        assert torch.equal(got, alive)
        return
    res = strategy.refine(
        params, alive, strategy.init_state(alive.shape[0], "cpu"), cfg,
        generator=torch.Generator().manual_seed(0), scene_scale=1.0,
        allow_split=False, allow_dup=False,
        scale_cull=cfg.scale_cull_active(step),
        screen_size_cull=cfg.screen_size_active(step))
    assert torch.equal(got, res.alive)
    assert int(res.n_cull) > 7

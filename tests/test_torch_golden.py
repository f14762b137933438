"""The port's golden renderer and camera helpers against the JAX package's,
and the port's tiled renderers against its golden, on the CPU.

``render_golden`` is held against JAX's ``render_golden`` on the same
numpy scene within 1e-5.  Then, mirroring tests/test_render.py:43-197,
the golden's own sanity cases (a single Gaussian's peak, a disk's normal,
two semi-transparent walls) and the tiled renderers against it: the
batched compositor (``render_tiled``, ``backend="xla"``) and the per-tile
one (``render_tiled_pallas``), pixels in both rasterize modes within 2e-5
(colour, alpha, normal) and 2e-4 (depths), gradients within rtol 1e-4 /
atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core import cameras as jcameras
from collab_splats_tpu.core.golden import render_golden as jgolden
from collab_splats_tpu.core.options import RenderOptions as JOpts
from collab_splats_tpu_torch.core import cameras as tcameras
from collab_splats_tpu_torch.core.cameras import (camera_from_numpy,
                                                  depth_pair_to_normal)
from collab_splats_tpu_torch.core.golden import render_golden
from collab_splats_tpu_torch.core.options import RenderOptions
from collab_splats_tpu_torch.core.sh import sh0_to_rgb
from collab_splats_tpu_torch.data.synthetic import (flat_disk_gaussian,
                                                    look_at_c2w,
                                                    orbit_cameras)
from collab_splats_tpu_torch.models.gaussians import params_from_numpy
from collab_splats_tpu_torch.ops.rasterize import (render_tiled,
                                                   render_tiled_pallas)
from test_torch_core import both_cameras, numpy_scene

torch.set_num_threads(2)
RENDERERS = {"xla": render_tiled, "pallas": render_tiled_pallas}


def activated(p):
    return (p["means"], p["quats"], torch.exp(p["scales"]),
            torch.sigmoid(p["opacities"][:, 0]), sh0_to_rgb(p["features_dc"]))


def front_camera(width=64, height=64, dist=2.0, focal=100.0):
    c2w = look_at_c2w(np.array([0.0, 0.0, dist]), np.zeros(3))
    return tcameras.make_camera(focal, focal, width / 2, height / 2, width,
                                height, c2w, device="cpu")


def orbit_camera(width, height, focal):
    return orbit_cameras(1, radius=2.5, width=width, height=height,
                         focal=focal, device="cpu")[0]


def scene(n, seed, extent):
    """Numpy scene: means in [-extent, extent], opacities in (0.5, 3)."""
    p, K, c2w = numpy_scene(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    p["means"] = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    p["opacities"] = rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    p["scales"] = np.log(rng.uniform(0.01, 0.05, (n, 3))).astype(np.float32)
    return p


@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_golden_matches_jax(mode):
    p, K, c2w = numpy_scene(120, seed=3, width=40, height=32)
    jcam, tcam = both_cameras(K, c2w, 40, 32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    import jax

    ref = jgolden(jp["means"], jp["quats"], jnp.exp(jp["scales"]),
                  jax.nn.sigmoid(jp["opacities"][:, 0]),
                  jax.nn.sigmoid(jp["features_dc"]), None, jcam,
                  JOpts(rasterize_mode=mode))
    tp = params_from_numpy(p, device="cpu")
    got = render_golden(tp["means"], tp["quats"], torch.exp(tp["scales"]),
                        torch.sigmoid(tp["opacities"][:, 0]),
                        torch.sigmoid(tp["features_dc"]), None, tcam,
                        RenderOptions(rasterize_mode=mode))
    assert float(jnp.max(ref.alpha)) > 0.5
    for name in ("color", "alpha", "depth", "median_depth", "normal"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert int(got.spilled) == 0


def test_single_gaussian_peak():
    cam = front_camera()
    m, q, s, o, c = activated(flat_disk_gaussian(radius=0.1, thickness=0.01,
                                                 device="cpu"))
    out = render_golden(m, q, s, o, c, None, cam)
    img = out.color.numpy()
    peak = np.unravel_index(img[..., 0].argmax(), img[..., 0].shape)
    assert abs(peak[0] - 32) <= 1 and abs(peak[1] - 32) <= 1
    assert img[32, 32, 0] > 0.5 * 0.8
    assert img[32, 32, 0] > img[32, 32, 1]
    assert 0.0 <= float(out.alpha.max()) <= 1.0
    assert abs(float(out.depth[32, 32]) - 2.0) < 0.05
    assert float(out.alpha[0, 0]) == 0.0


def test_disk_normal_consistency():
    cam = front_camera(width=96, height=96, focal=200.0)
    m, q, s, o, c = activated(flat_disk_gaussian(
        normal=(0.2, 0.1, 0.95), radius=0.25, device="cpu"))
    out = render_golden(m, q, s, o, c, None, cam)
    center = out.normal[44:52, 44:52].numpy()
    alpha_c = out.alpha[44:52, 44:52].numpy()
    n = center / np.clip(alpha_c[..., None], 1e-6, None)
    assert np.all(n[..., 2] < 0)
    dn = depth_pair_to_normal(cam, out.depth, out.median_depth)[0].numpy()
    dots = np.sum(dn[44:52, 44:52]
                  * n / np.linalg.norm(n, axis=-1, keepdims=True), -1)
    assert dots.mean() > 0.95


def test_median_vs_expected_two_walls():
    cam = front_camera(focal=60.0)
    front = flat_disk_gaussian(center=(0, 0, 0.5), radius=0.8,
                               thickness=1e-3, device="cpu")
    back = flat_disk_gaussian(center=(0, 0, -0.5), radius=0.8,
                              thickness=1e-3, device="cpu")
    p = {k: torch.cat([front[k], back[k]]) for k in front}
    p["opacities"] = torch.full((2, 1), 0.4055)   # sigmoid -> 0.6
    out = render_golden(*activated(p), None, cam)
    assert float(out.median_depth[32, 32]) == pytest.approx(1.5, abs=0.05)
    assert 1.55 < float(out.depth[32, 32]) < 2.2


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_tiled_pixel_parity(backend, mode):
    cam = orbit_camera(72, 56, 90.0)
    args = activated(params_from_numpy(scene(300, 2, 0.8), device="cpu"))
    opts = RenderOptions(rasterize_mode=mode, tile_capacity=512,
                         max_intersections=1 << 15)
    gold = render_golden(*args, None, cam, opts)
    tiled, _ = RENDERERS[backend](*args, cam, opts)
    assert int(tiled.spilled) == 0
    for name, atol in (("color", 2e-5), ("alpha", 2e-5), ("normal", 2e-5),
                       ("depth", 2e-4), ("median_depth", 2e-4)):
        np.testing.assert_allclose(getattr(tiled, name).numpy(),
                                   getattr(gold, name).numpy(), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_tiled_gradient_parity(backend):
    cam = orbit_camera(48, 48, 70.0)
    p = params_from_numpy(scene(150, 4, 0.7), device="cpu")
    target = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (48, 48, 3)).astype(np.float32))
    opts = RenderOptions(tile_capacity=256, max_intersections=1 << 14)
    names = ("means", "scales", "quats", "opacities", "features_dc")

    def grads(render):
        leaves = {k: p[k].clone().requires_grad_(True) for k in names}
        out = render(leaves["means"], leaves["quats"],
                     torch.exp(leaves["scales"]),
                     torch.sigmoid(leaves["opacities"][:, 0]),
                     sh0_to_rgb(leaves["features_dc"]))
        loss = (torch.mean((out.color - target) ** 2)
                + 0.05 * torch.mean(out.depth * target[..., 0])
                + 0.05 * torch.mean(out.normal * target)
                + 0.05 * torch.mean(out.alpha))
        return torch.autograd.grad(loss, [leaves[k] for k in names])

    g_gold = grads(lambda m, q, s, o, c: render_golden(m, q, s, o, c, None,
                                                       cam, opts))
    g_tile = grads(lambda m, q, s, o, c: RENDERERS[backend](
        m, q, s, o, c, cam, opts)[0])
    for gg, gt, name in zip(g_gold, g_tile, names):
        np.testing.assert_allclose(gt.numpy(), gg.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("factor", [2.0, 3.0, 0.5])
def test_camera_helpers_match_jax(factor):
    _, K, c2w = numpy_scene(1, width=97, height=61)
    jcam, tcam = both_cameras(K, c2w, 97, 61)
    jr, tr = jcam.resized(factor), tcam.resized(factor)
    assert (tr.width, tr.height) == (jr.width, jr.height)
    np.testing.assert_array_equal(tr.K.numpy(), np.asarray(jr.K))
    np.testing.assert_array_equal(tr.c2w.numpy(), np.asarray(jr.c2w))
    for focal, pixels in ((50.0 * factor, 97), (1234.5, 1280)):
        fov = tcameras.focal2fov(focal, pixels)
        assert fov == jcameras.focal2fov(focal, pixels)
        assert tcameras.fov2focal(fov, pixels) == jcameras.fov2focal(
            fov, pixels)
        assert tcameras.fov2focal(fov, pixels) == pytest.approx(focal)


def test_golden_follows_its_inputs_device():
    """No device argument: the maps live where the inputs live."""
    cam = camera_from_numpy(np.eye(3, dtype=np.float32) * [8, 8, 1]
                            + [[0, 0, 4], [0, 0, 4], [0, 0, 0]],
                            look_at_c2w(np.array([0, 0, 3.0]), np.zeros(3)),
                            8, 8, device="cpu")
    out = render_golden(*activated(flat_disk_gaussian(device="cpu")), None,
                        cam)
    assert all(t.device.type == "cpu" for t in out)
    assert out.color.shape == (8, 8, 3)

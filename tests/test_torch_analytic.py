"""The port's analytic ray-traced ground truth (``data/analytic.py``).

tests/test_analytic.py's eight cases on the port's copy, then its arrays
against the JAX package's: ``render_analytic`` on a camera carried across
(the same K and c2w float32 values), ``seed_points_from_views`` and
``sample_gt_surface`` bit for bit (both are float64 numpy inside).
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

from collab_splats_tpu.data import analytic as janalytic
from collab_splats_tpu.data.synthetic import orbit_cameras as jorbit
from collab_splats_tpu_torch.data.analytic import (default_scene,
                                                   render_analytic,
                                                   sample_gt_surface,
                                                   seed_points_from_views)
from collab_splats_tpu_torch.data.synthetic import orbit_cameras
from test_torch_core import both_cameras


def cameras(n, width, height):
    return orbit_cameras(n, radius=3.2, width=width, height=height,
                         focal=0.9 * width, device="cpu")


def render_one(width=160, height=90, cam_idx=0):
    scene = default_scene(seed=7)
    cams = cameras(4, width, height)
    return scene, cams, render_analytic(scene, cams[cam_idx])


def test_deterministic():
    _, _, a = render_one()
    _, _, b = render_one()
    np.testing.assert_array_equal(a["rgb"], b["rgb"])


def test_full_coverage_and_range():
    _, _, r = render_one()
    assert r["rgb"].shape == (90, 160, 3)
    assert r["hit"].mean() > 0.99
    assert r["rgb"].min() >= 0.0 and r["rgb"].max() <= 1.0
    assert np.isfinite(r["rgb"]).all()


def test_depth_consistent_with_points():
    _, cams, r = render_one()
    K = cams[0].K.numpy()
    c2w = cams[0].c2w.numpy()
    ys, xs = 45, 80
    z = r["depth"][ys, xs]
    assert np.isfinite(z) and z > 0
    d_gl = np.array([(xs + 0.5 - K[0, 2]) / K[0, 0],
                     -(ys + 0.5 - K[1, 2]) / K[1, 1], -1.0])
    p = c2w[:3, 3] + c2w[:3, :3] @ (d_gl * z)
    np.testing.assert_allclose(p, r["points"][ys, xs], atol=1e-3)


def test_view_dependence():
    scene = default_scene(seed=7)
    cams = cameras(2, 120, 68)
    a = render_analytic(scene, cams[0])["rgb"]
    b = render_analytic(scene, cams[1])["rgb"]
    assert np.abs(a - b).mean() > 0.01


def test_hard_shadows_present():
    _, _, r = render_one(width=320, height=180)
    lum = r["rgb"].mean(axis=-1)
    assert lum.max() - lum.min() > 0.5


def test_seed_cloud():
    scene, cams, _ = render_one()
    renders = [render_analytic(scene, c) for c in cams]
    cloud = seed_points_from_views(scene, cams, renders, 500, seed=1)
    assert cloud["points"].shape == (500, 3)
    assert cloud["colors"].shape == (500, 3)
    r = np.linalg.norm(cloud["points"][:, :2], axis=1)
    assert (r < scene.wall_radius + 0.1).all()
    assert (cloud["points"][:, 2] > scene.plane_z - 0.1).all()


def test_seed_points_near_true_surfaces():
    scene, cams, _ = render_one()
    renders = [render_analytic(scene, c) for c in cams]
    cloud = seed_points_from_views(scene, cams, renders, 400, seed=2,
                                   noise=0.0)
    surf = sample_gt_surface(scene, 200_000, seed=3)
    d, _ = cKDTree(surf).query(cloud["points"])
    assert np.percentile(d, 95) < 0.08


def test_surface_sampler_counts():
    pts = sample_gt_surface(default_scene(seed=7), 10_000, seed=0)
    assert abs(len(pts) - 10_000) < 20
    assert np.isfinite(pts).all()


def test_scene_matches_jax():
    a, b = default_scene(seed=7), janalytic.default_scene(seed=7)
    for f in ("sphere_centers", "sphere_radii", "sphere_colors_a",
              "sphere_colors_b", "sphere_freq", "light_dir"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("cam_idx", [0, 2])
def test_arrays_match_jax_bit_for_bit(cam_idx):
    scene, jscene = default_scene(seed=7), janalytic.default_scene(seed=7)
    jcams = jorbit(4, radius=3.2, width=96, height=54, focal=0.9 * 96)
    pairs = [both_cameras(np.asarray(c.K), np.asarray(c.c2w), 96, 54)
             for c in jcams]
    jr = [janalytic.render_analytic(jscene, j) for j, _ in pairs]
    tr = [render_analytic(scene, t) for _, t in pairs]
    for key in ("rgb", "points", "hit", "depth"):
        np.testing.assert_array_equal(tr[cam_idx][key], jr[cam_idx][key],
                                      err_msg=key)
    jc = janalytic.seed_points_from_views(jscene, [j for j, _ in pairs], jr,
                                          300, seed=4)
    tc = seed_points_from_views(scene, [t for _, t in pairs], tr, 300,
                                seed=4)
    for key in ("points", "colors"):
        np.testing.assert_array_equal(tc[key], jc[key], err_msg=key)
    np.testing.assert_array_equal(sample_gt_surface(scene, 5000, seed=cam_idx),
                                  janalytic.sample_gt_surface(
                                      jscene, 5000, seed=cam_idx))

"""Parity of the port's spectral Poisson reconstruction with the JAX
package's, on the CPU.

Tolerances:

* the trilinear splat through ``ops/segsum.py::segment_sum`` (the sorted
  segment sum) against JAX's eight ``.at[].add`` scatters: within 1e-6
  relative (both sum each voxel's rows corner-major, in point order);
* ``_poisson_field``: chi within 1e-4 of max|chi| (pocketfft in both, the
  spectra rounded in another order);
* ``poisson_reconstruct`` and the two Poisson exporters, on the sphere
  scene of tests/test_poisson.py and the disk of tests/test_meshing.py:
  vertex count within 2%, symmetric mean Chamfer distance at most 0.25
  voxel, per-vertex colours within 1e-4 at matched vertices with sample
  support (see :func:`supported`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.meshing import exporters as jexp
from collab_splats_tpu.meshing import poisson as jpoisson
from collab_splats_tpu_torch.meshing import exporters as texp
from collab_splats_tpu_torch.meshing import poisson as tpoisson
from test_torch_meshing import (assert_meshes_match, both_configs,
                                both_orbits, both_params, disk_scene)

torch.set_num_threads(2)


def sphere_samples(n=20000, radius=1.0, noise=0.0, seed=0):
    """tests/test_poisson.py's sampled unit sphere with radial normals."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * (radius + noise * rng.randn(n, 1))
    return pts.astype(np.float32), d.astype(np.float32)


def voxel_of(points, grid_res, margin=0.1):
    """The solve's voxel size for ``points`` (poisson_reconstruct's)."""
    span = float((points.max(0) - points.min(0)).max())
    return (span + 2 * margin * span) / (grid_res - 1)


def supported(points, grid_res, verts, margin=0.1, least=1e-3):
    """Vertices whose splatted sample weight is at least ``least``.  A
    vertex colour is the ratio of two splatted sums, divided by at least
    1e-6; where the weight is near that floor the ratio is ill-conditioned
    (a 1e-6-voxel move changes it by 1e-3), so only supported vertices'
    colours are compared."""
    points = np.asarray(points, np.float32)
    lo = points.min(0)
    span = float((points.max(0) - lo).max()) or 1.0
    origin = lo - margin * span
    scale = (span + 2 * margin * span) / (grid_res - 1)
    ones = jnp.ones((len(points), 1), jnp.float32)
    grid = np.asarray(jpoisson._trilinear_scatter(
        grid_res, jnp.asarray((points - origin) / scale), ones))
    w = jpoisson.trilinear_sample(grid, (np.asarray(verts) - origin) / scale)
    return w[:, 0] >= least


@pytest.mark.parametrize("r,n,c", [(16, 3000, 4), (24, 500, 7)])
def test_trilinear_scatter_matches(r, n, c):
    rng = np.random.default_rng(r)
    pts = rng.uniform(-0.5, r - 0.5, (n, 3)).astype(np.float32)
    pts[:5] = [[0, 0, 0], [r - 1, r - 1, r - 1], [r - 1.5, 0.2, 3.0],
               [-0.4, r - 0.6, 1.0], [2.0, 2.0, 2.0]]
    vals = rng.normal(size=(n, c)).astype(np.float32)
    ref = np.asarray(jpoisson._trilinear_scatter(r, jnp.asarray(pts),
                                                 jnp.asarray(vals)))
    got = tpoisson._trilinear_scatter(r, torch.from_numpy(pts),
                                      torch.from_numpy(vals)).numpy()
    assert got.shape == ref.shape == (r, r, r, c)
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))
    ids, rows = tpoisson.scatter_rows(r, torch.from_numpy(pts),
                                      torch.from_numpy(vals))
    assert ids.dtype == torch.int32 and ids.shape == (8 * n,)
    assert rows.shape == (8 * n, c)


@pytest.mark.parametrize("screen", [0.0, 0.5])
def test_poisson_field_matches(screen):
    pts, nrm = sphere_samples(n=6000)
    r = 40
    pts_vox = (pts - pts.min(0) + 0.2) / (pts.max(0) - pts.min(0) + 0.4) \
        * (r - 1)
    pts_vox = pts_vox.astype(np.float32)
    ref = np.asarray(jpoisson._poisson_field(
        jnp.asarray(pts_vox), jnp.asarray(nrm), r, screen))
    got = tpoisson._poisson_field(torch.from_numpy(pts_vox),
                                  torch.from_numpy(nrm), r, screen).numpy()
    assert got.shape == ref.shape == (r, r, r)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("grid_res,screen,noise", [(64, 0.0, 0.0),
                                                   (48, 0.5, 0.02)])
def test_poisson_reconstruct_matches(grid_res, screen, noise):
    pts, nrm = sphere_samples(n=8000, noise=noise, seed=1)
    cols = (pts * 0.5 + 0.5).astype(np.float32)
    jv, jf, jc = jpoisson.poisson_reconstruct(pts, nrm, grid_res=grid_res,
                                              screen=screen, colors=cols)
    tv, tf, tc = tpoisson.poisson_reconstruct(
        pts, nrm, grid_res=grid_res, screen=screen, colors=cols,
        device="cpu")
    assert tf.dtype == np.int32 and tc.shape == (len(tv), 3)
    assert_meshes_match(tv, tf, jv, jf, voxel_of(pts, grid_res),
                        [(tc, jc)], keep=supported(pts, grid_res, tv))


def test_poisson_reconstruct_empty():
    v, f, c = tpoisson.poisson_reconstruct(np.zeros((0, 3)),
                                           np.zeros((0, 3)), grid_res=32,
                                           device="cpu")
    assert len(v) == 0 and len(f) == 0 and c is None


def test_depth_normal_poisson_exporter_matches(tmp_path):
    p = disk_scene(extra=20, seed=7, radius=0.4, thickness=0.02)
    jp, ja, tp, ta = both_params(p)
    jm, tm = both_configs()
    jcams, tcams = both_orbits(4, radius=2.0, width=48, height=48,
                               focal=60.0, elevation=0.9)
    kw = dict(alpha_thresh=0.5, stride=2, grid_res=48)
    ref = jexp.DepthAndNormalMapsPoissonExporter(jp, ja, jm, **kw).main(
        jcams)
    got = texp.DepthAndNormalMapsPoissonExporter(tp, ta, tm, **kw).main(
        tcams, output_dir=tmp_path)
    assert (tmp_path / "oriented_points.ply").exists()
    assert (tmp_path / "mesh.ply").exists()
    assert got["points"].shape == ref["points"].shape
    for k in ("points", "normals", "colors"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert_meshes_match(got["vertices"], got["faces"], ref["vertices"],
                        ref["faces"], voxel_of(ref["points"], 48),
                        [(got["vertex_colors"], ref["vertex_colors"])],
                        keep=supported(ref["points"], 48, got["vertices"]))


def test_gaussians_to_poisson_matches(tmp_path):
    """Flat splats on a sphere, each with its smallest axis radial."""
    pts, nrm = sphere_samples(n=3000, seed=2)
    rng = np.random.default_rng(3)
    # The rotation taking z to the normal: half-way quaternion (w, z x n).
    axis = np.cross([0.0, 0.0, 1.0], nrm)
    q = np.concatenate([1.0 + nrm[:, 2:3], axis], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    n = len(pts)
    p = {
        "means": pts, "quats": q,
        "scales": np.log(np.tile([0.03, 0.03, 0.002], (n, 1))),
        "opacities": rng.uniform(-3.0, 3.0, (n, 1)),
        "features_dc": rng.uniform(-1.5, 1.5, (n, 3)),
        "features_rest": np.zeros((n, 0, 3)),
    }
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    jp, ja, tp, ta = both_params(p)
    jm, tm = both_configs()
    ref = jexp.GaussiansToPoissonExporter(jp, ja, jm, grid_res=48).main(
        tmp_path / "jax")
    got = texp.GaussiansToPoissonExporter(tp, ta, tm, grid_res=48).main(
        tmp_path / "port")
    assert (tmp_path / "port" / "mesh.ply").exists()
    for k in ("points", "colors"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["normals"], ref["normals"], atol=1e-6)
    assert_meshes_match(got["vertices"], got["faces"], ref["vertices"],
                        ref["faces"], voxel_of(ref["points"], 48),
                        [(got["vertex_colors"], ref["vertex_colors"])],
                        keep=supported(ref["points"], 48, got["vertices"]))

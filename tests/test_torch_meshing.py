"""Parity of the port's meshing with the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function and the port's.
Tolerances:

* ``marching_tetrahedra``, ``trilinear_sample``, ``clean_repair_mesh`` (with
  the native library and with the numpy path) and
  ``floor_alignment_transform`` are own copies: identical arrays.
* ``integrate``, over several cameras, one of them inside the volume with
  voxels behind and beside it: ``weight`` equal, and tsdf, color and
  features within 1e-5, on every voxel except those whose ``sdf > -1``,
  depth-validity or pixel decision sits within rounding of its threshold
  (counted; at most 1e-4 of the voxels).
* ``knn_weighted_transfer``: the same neighbour sets, values within rtol
  1e-5 / atol 1e-6.
* ``gaussian_density_grid``: within 1e-5 of the field's maximum.
* exporters: vertex count within 2%, symmetric mean Chamfer distance at
  most 0.25 voxel, per-vertex colours / normals / features within 1e-4 at
  matched vertices.
* ``utils/metrics.py``: lookups equal, KD-tree metrics equal, angular error
  within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from collab_splats_tpu.core.cameras import make_camera as jmake_camera
from collab_splats_tpu.core.options import RenderOptions as JOpts
from collab_splats_tpu.data import synthetic as jsyn
from collab_splats_tpu.meshing import align as jalign
from collab_splats_tpu.meshing import exporters as jexp
from collab_splats_tpu.meshing import marching as jmarch
from collab_splats_tpu.meshing import repair as jrepair
from collab_splats_tpu.meshing import transfer as jtransfer
from collab_splats_tpu.meshing import tsdf as jtsdf
from collab_splats_tpu.models import rade_gs as jrade
from collab_splats_tpu.ops.rasterize import RenderMeta as JRenderMeta
from collab_splats_tpu.utils import metrics as jmetrics
from collab_splats_tpu_torch.core.cameras import camera_from_numpy
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.data import synthetic as tsyn
from collab_splats_tpu_torch.meshing import _native as tnative
from collab_splats_tpu_torch.meshing import align as talign
from collab_splats_tpu_torch.meshing import exporters as texp
from collab_splats_tpu_torch.meshing import marching as tmarch
from collab_splats_tpu_torch.meshing import repair as trepair
from collab_splats_tpu_torch.meshing import transfer as ttransfer
from collab_splats_tpu_torch.meshing import tsdf as ttsdf
from collab_splats_tpu_torch.models import rade_gs as trade
from collab_splats_tpu_torch.models.gaussians import params_from_numpy
from collab_splats_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)
ATTR_TOL = 1e-4
CHAMFER_VOXELS = 0.25


# -- scenes -----------------------------------------------------------------

def disk_scene(extra=0, latent=0, seed=0, radius=0.5, thickness=0.005):
    """The opaque disk of tests/test_meshing.py, plus ``extra`` small flat
    Gaussians lying on it and ``latent`` seeded latents per Gaussian; raw
    numpy float32 parameters."""
    d = jsyn.flat_disk_gaussian(normal=(0, 0, 1), radius=radius,
                                thickness=thickness)
    p = {k: np.asarray(v) for k, v in d.items()}
    p["opacities"] = np.full((1, 1), 8.0, np.float32)
    rng = np.random.default_rng(seed)
    if extra:
        r = radius * 0.9 * np.sqrt(rng.uniform(0, 1, extra))
        a = rng.uniform(0, 2 * np.pi, extra)
        h = rng.uniform(0, np.pi, extra)
        add = {
            "means": np.stack([r * np.cos(a), r * np.sin(a),
                               rng.uniform(-0.004, 0.004, extra)], -1),
            "scales": np.log(np.stack([rng.uniform(0.02, 0.05, extra),
                                       rng.uniform(0.02, 0.05, extra),
                                       np.full(extra, 0.002)], -1)),
            # Rotations about z keep each Gaussian flat in the plane.
            "quats": np.stack([np.cos(h), np.zeros(extra), np.zeros(extra),
                               np.sin(h)], -1),
            "opacities": rng.uniform(1.0, 4.0, (extra, 1)),
            "features_dc": rng.uniform(-1.5, 1.5, (extra, 3)),
            "features_rest": np.zeros((extra, 0, 3)),
        }
        p = {k: np.concatenate([p[k], add[k].astype(np.float32)])
             for k in p}
    n = p["means"].shape[0]
    if latent:
        p["distill_features"] = rng.uniform(-1, 1, (n, latent))
    return {k: v.astype(np.float32) for k, v in p.items()}


def both_params(p):
    n = p["means"].shape[0]
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.ones(n, bool),
            params_from_numpy(p, device="cpu"), torch.ones(n, dtype=bool))


def both_configs(latent=0, **opts):
    render = dict(tile_capacity=64, max_intersections=1 << 12, **opts)
    return (jrade.RadeGSConfig(sh_degree=0, background="black",
                               latent_dim=latent, render=JOpts(**render)),
            trade.RadeGSConfig(sh_degree=0, background="black",
                               latent_dim=latent, render=TOpts(**render)))


def both_orbits(n, **kw):
    return (jsyn.orbit_cameras(n, **kw),
            tsyn.orbit_cameras(n, device="cpu", **kw))


def both_cameras(K, c2w, width, height):
    return (jmake_camera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height,
                         jnp.asarray(c2w)),
            camera_from_numpy(K, c2w, width, height, device="cpu"))


def assert_meshes_match(got_v, got_f, ref_v, ref_f, voxel, attrs=(),
                        keep=None):
    """Vertex counts within 2%, symmetric mean Chamfer distance at most
    0.25 voxel, and each (got, ref) per-vertex attribute pair within 1e-4
    at the vertices that match (mutual nearest, closer than 1e-5 voxel;
    and where ``keep``, a mask over ``got_v``, holds).  Returns the
    Chamfer distance in voxels."""
    got_v, ref_v = np.asarray(got_v, np.float64), np.asarray(ref_v, np.float64)
    assert len(ref_v) > 0 and len(got_f) > 0 and len(ref_f) > 0
    assert abs(len(got_v) - len(ref_v)) <= 0.02 * len(ref_v), \
        (len(got_v), len(ref_v))
    d_gr, i_gr = cKDTree(ref_v).query(got_v)
    d_rg, i_rg = cKDTree(got_v).query(ref_v)
    chamfer = 0.5 * (d_gr.mean() + d_rg.mean()) / voxel
    assert chamfer <= CHAMFER_VOXELS, chamfer
    mutual = (i_rg[i_gr] == np.arange(len(got_v))) & (d_gr < 1e-5 * voxel)
    assert mutual.mean() > 0.5, mutual.mean()
    if keep is not None:
        mutual &= keep
    for got, ref in attrs:
        np.testing.assert_allclose(np.asarray(got)[mutual],
                                   np.asarray(ref)[i_gr[mutual]],
                                   rtol=0, atol=ATTR_TOL)
    return chamfer


# -- host copies: identical arrays -------------------------------------------

def fields():
    n = 28
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    sphere = np.sqrt(((g - c) ** 2).sum(0)) - n / 4
    rng = np.random.default_rng(3)
    noisy = (sphere + rng.normal(0, 1.5, sphere.shape)).astype(np.float32)
    plane = np.tile((np.arange(n, dtype=np.float32) - 9.0)[None, None, :],
                    (n, n, 1))
    mask = rng.uniform(0, 1, sphere.shape) > 0.05
    return {"sphere": (sphere, 0.0, None), "noisy": (noisy, 0.0, mask),
            "plane": (plane, 0.0, None), "level": (sphere, 1.5, None)}


@pytest.mark.parametrize("name", ["sphere", "noisy", "plane", "level"])
def test_marching_tetrahedra_identical(name):
    sdf, level, mask = fields()[name]
    jv, jf = jmarch.marching_tetrahedra(sdf, level=level, mask=mask)
    tv, tf = tmarch.marching_tetrahedra(sdf, level=level, mask=mask)
    assert len(jf) > 0
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(9, 7, 8, 3)).astype(np.float32)
    pts = rng.uniform(-1, 10, (300, 3))
    np.testing.assert_array_equal(tmarch.trilinear_sample(grid, pts),
                                  jmarch.trilinear_sample(grid, pts))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_clean_repair_identical(monkeypatch, native):
    from collab_splats_tpu.meshing import _native as jnative

    if not native:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "load", lambda *a, **k: None)
    elif tnative.load() is None:
        pytest.fail("libmesh_repair.so could not be built or loaded")
    sdf, level, mask = fields()["noisy"]
    verts, faces = jmarch.marching_tetrahedra(sdf, level=level, mask=mask)
    assert len(np.unique(trepair.face_components(verts, faces))) > 1
    np.testing.assert_array_equal(trepair.face_components(verts, faces),
                                  jrepair.face_components(verts, faces))
    tl, jl = trepair.boundary_loops(faces), jrepair.boundary_loops(faces)
    assert len(tl) == len(jl) > 0
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)
    for frac, holes in ((0.05, 64), (0.5, 8)):
        tv, tf = trepair.clean_repair_mesh(verts, faces, frac, holes)
        jv, jf = jrepair.clean_repair_mesh(verts, faces, frac, holes)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def test_floor_alignment_identical():
    rng = np.random.RandomState(0)
    xy = rng.uniform(-1, 1, (1500, 2))
    floor = np.stack([xy[:, 0], xy[:, 1],
                      0.3 * xy[:, 0] + 0.1 * xy[:, 1] + 0.5], -1)
    pts = np.concatenate([floor, rng.normal(0, 0.1, (400, 3)) + [0, 0, 1.5]])
    T = talign.floor_alignment_transform(pts, distance_threshold=0.02,
                                         num_iterations=300, seed=3)
    np.testing.assert_array_equal(
        T, jalign.floor_alignment_transform(pts, distance_threshold=0.02,
                                            num_iterations=300, seed=3))
    np.testing.assert_array_equal(talign.apply_transform(pts, T),
                                  jalign.apply_transform(pts, T))
    assert np.abs(talign.apply_transform(floor, T)[:, 2]).max() < 0.05


def test_flat_disk_gaussian_matches():
    for kw in ({}, {"center": (0.1, -0.2, 0.3), "normal": (1.0, 0.2, 0.1),
                    "radius": 0.4, "thickness": 0.02}):
        ref = jsyn.flat_disk_gaussian(**kw)
        got = tsyn.flat_disk_gaussian(device="cpu", **kw)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


# -- TSDF --------------------------------------------------------------------

def test_volume_from_bounds_matches():
    lo, hi = np.array([-1.0, -0.7, -1.2]), np.array([1.1, 0.9, 0.8])
    for kw in ({"voxel_size": 0.05}, {"voxel_size": 0.001, "max_dim": 64},
               {"voxel_size": 0.04, "feature_dim": 5, "sdf_trunc": 0.01}):
        jcfg, jvol = jtsdf.volume_from_bounds(lo, hi, **kw)
        tcfg, tvol = ttsdf.volume_from_bounds(lo, hi, device="cpu", **kw)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for name in ("tsdf", "weight", "color", "features"):
            a, b = getattr(tvol, name), getattr(jvol, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def margin_voxels(cfg, cam, depth, alpha, alpha_thresh, eps=1e-5):
    """Voxels one of whose decisions for this camera sits within rounding
    of its threshold, in float64: sdf at -1, the observed depth at 1e-6 or
    depth_trunc, alpha at its threshold (each within ``eps``), and the
    pixel it reads (u or v within float32 rounding of an integer: XLA and
    ATen round the voxel's camera position differently)."""
    d = cfg.dims
    axes = [np.arange(d[i]) * cfg.voxel_size + cfg.origin[i] for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    w2c = cam.viewmat().numpy().astype(np.float64)
    p = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = np.maximum(p[:, 2], 1e-6)
    K = cam.K.numpy().astype(np.float64)
    u = K[0, 0] * p[:, 0] / z + K[0, 2]
    v = K[1, 1] * p[:, 1] / z + K[1, 2]
    # A few float32 ulps of the camera position, through the projection.
    eps_pix = 1e-6 * K[0, 0] * (1.0 + np.abs(p[:, :2]).max(-1) / z) / z
    ui = np.clip(np.floor(np.clip(u, -1, cam.width)), 0, cam.width - 1)
    vi = np.clip(np.floor(np.clip(v, -1, cam.height)), 0, cam.height - 1)
    pix = (vi * cam.width + ui).astype(np.int64)
    d_obs = depth.reshape(-1).astype(np.float64)[pix]
    a = alpha.reshape(-1).astype(np.float64)[pix]
    sdf = (d_obs - p[:, 2]) / cfg.sdf_trunc
    return ((np.abs(sdf + 1.0) < eps) | (np.abs(d_obs - 1e-6) < eps)
            | (np.abs(d_obs - cfg.depth_trunc) < eps)
            | (np.abs(a - alpha_thresh) < eps) | (np.abs(p[:, 2]) < eps)
            | (np.abs(u - np.round(u)) < eps_pix)
            | (np.abs(v - np.round(v)) < eps_pix))


def test_integrate_matches():
    cfg_kw = dict(voxel_size=0.025, sdf_trunc=0.15, depth_trunc=2.5,
                  origin=(-0.6, -0.5, -0.7), dims=(48, 40, 56), feature_dim=4)
    jcfg, tcfg = jtsdf.TSDFConfig(**cfg_kw), ttsdf.TSDFConfig(**cfg_kw)
    jvol, tvol = jtsdf.create_volume(jcfg), ttsdf.create_volume(tcfg, "cpu")
    width, height = 64, 48
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    # Targets off the voxel centres: a centre on the optical axis projects
    # exactly onto a pixel corner, where any rounding moves it.
    eyes = [((2.0, 0.3, 0.9), (0.013, -0.007, 0.011)),
            ((-1.2, 1.6, -0.4), (-0.009, 0.012, 0.004)),
            ((0.3, -2.1, 0.2), (0.1, 0.11, 0.003)),
            # Inside the volume: voxels behind the camera plane and beside
            # the image, whose u, v overflow before the clamp.
            ((0.05, -0.1, 0.02), (1.0, 0.3, -0.2))]
    # Jitted, as the JAX exporter runs it (XLA rounds the eager and the
    # jitted voxel projection differently).
    jinteg = jax.jit(lambda vol, depth, rgb, cam, feats, alpha:
                     jtsdf.integrate(vol, depth, rgb, cam, jcfg,
                                     features=feats, alpha=alpha))
    rng = np.random.default_rng(11)
    margin = np.zeros(int(np.prod(cfg_kw["dims"])), bool)
    for eye, target in eyes:
        c2w = tsyn.look_at_c2w(np.asarray(eye, np.float64),
                               np.asarray(target, np.float64))
        jcam, tcam = both_cameras(K, c2w, width, height)
        depth = rng.uniform(0.2, 3.0, (height, width)).astype(np.float32)
        depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
        rgb = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
        feats = rng.normal(size=(height, width, 4)).astype(np.float32)
        alpha = rng.uniform(0, 1, (height, width)).astype(np.float32)
        jvol = jinteg(jvol, jnp.asarray(depth), jnp.asarray(rgb), jcam,
                      jnp.asarray(feats), jnp.asarray(alpha))
        tvol = ttsdf.integrate(tvol, torch.from_numpy(depth),
                               torch.from_numpy(rgb), tcam, tcfg,
                               features=torch.from_numpy(feats),
                               alpha=torch.from_numpy(alpha))
        margin |= margin_voxels(tcfg, tcam, depth, alpha, 0.5)
    w_got, w_ref = tvol.weight.numpy().reshape(-1), np.asarray(
        jvol.weight).reshape(-1)
    assert w_ref.max() >= 3 and (w_ref > 0).mean() > 0.05
    # Voxels whose update or pixel decision flipped: their weight, or a
    # value read from another pixel, differs.  Each must sit in the margin
    # of a decision, and at most 1e-4 of the voxels may.
    differ = w_got != w_ref
    for name in ("tsdf", "color", "features"):
        got = getattr(tvol, name).numpy()
        ref = np.asarray(getattr(jvol, name))
        assert got.shape == ref.shape
        err = np.abs(got - ref).reshape(len(differ), -1).max(-1)
        differ |= err > 1e-5
    assert not (differ & ~margin).any()
    assert differ.sum() <= 1e-4 * differ.size, differ.sum()


# -- k-NN transfer -----------------------------------------------------------

@pytest.mark.parametrize("v,n,k,sigma,chunk", [
    (1000, 300, 5, None, 256),     # V no multiple of the chunk
    (777, 500, 3, 0.2, 100),       # RBF weights
    (50, 4, 8, None, 4096),        # k > N
])
def test_knn_transfer_matches(v, n, k, sigma, chunk):
    rng = np.random.default_rng(v)
    q = rng.uniform(-1, 1, (v, 3)).astype(np.float32)
    s = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vals = rng.normal(size=(n, 6)).astype(np.float32)
    ref = jtransfer.knn_weighted_transfer(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(vals), k=k, sigma=sigma,
        chunk=chunk)
    got = ttransfer.knn_weighted_transfer(
        torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(vals),
        k=k, sigma=sigma, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # The neighbour sets, against JAX's top_k of its own distances.
    d2 = jnp.sum((jnp.asarray(q)[:, None] - jnp.asarray(s)[None]) ** 2, -1)
    _, jidx = jax.lax.top_k(-d2, min(k, n))
    tidx, _ = ttransfer.knn_neighbours(torch.from_numpy(q),
                                       torch.from_numpy(s), k, chunk)
    np.testing.assert_array_equal(np.sort(tidx.numpy(), 1),
                                  np.sort(np.asarray(jidx), 1))


def test_transfer_shares_neighbours():
    """Values moved together (the exporter's normals ++ latents) equal the
    values moved apart."""
    rng = np.random.default_rng(2)
    q, s = (torch.from_numpy(rng.uniform(-1, 1, (300, 3)).astype(np.float32))
            for _ in range(2))
    a = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(300, 13)).astype(np.float32))
    idx, d2 = ttransfer.knn_neighbours(q, s)
    both = ttransfer.apply_weights(idx, ttransfer.knn_weights(d2),
                                   torch.cat([a, b], -1))
    assert torch.equal(both[:, :3], ttransfer.knn_weighted_transfer(q, s, a))
    assert torch.equal(both[:, 3:], ttransfer.knn_weighted_transfer(q, s, b))


# -- density grid and exporters ---------------------------------------------

def test_density_grid_matches():
    p = disk_scene(extra=60, seed=4)
    jp, ja, tp, ta = both_params(p)
    lo, hi = p["means"].min(0) - 0.1, p["means"].max(0) + 0.1
    for weighted in (True, False):
        ref, jvox, jorg = jexp.gaussian_density_grid(
            jp, ja, lo, hi, 20, opacity_weighted=weighted, chunk=512)
        got, tvox, torg = texp.gaussian_density_grid(
            tp, ta, lo, hi, 20, opacity_weighted=weighted, chunk=512)
        assert got.shape == ref.shape == (20, 20, 20)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))
        np.testing.assert_array_equal(tvox, jvox)
        np.testing.assert_array_equal(torg, jorg)


def test_tsdf_exporter_matches(tmp_path):
    latent = 3
    p = disk_scene(extra=40, latent=latent, seed=5)
    jp, ja, tp, ta = both_params(p)
    jm, tm = both_configs(latent)
    jcams, tcams = both_orbits(6, radius=2.0, width=64, height=64,
                               focal=80.0, elevation=0.9)
    kw = dict(voxel_size=0.04, sdf_trunc=0.12, depth_trunc=4.0,
              align_floor=True, max_dim=64, clean_repair=True)
    ref = jexp.TSDFFusionExporter(jp, ja, jm,
                                  jexp.TSDFExporterConfig(**kw)).main(
        jcams, output_dir=tmp_path / "jax")
    exporter = texp.TSDFFusionExporter(tp, ta, tm,
                                       texp.TSDFExporterConfig(**kw))
    got = exporter.main(tcams, output_dir=tmp_path / "port")
    for f in ("splats.ply", "mesh.ply", "mesh_features.npz"):
        assert (tmp_path / "port" / f).exists(), f
    assert got["features"].shape == (len(got["vertices"]), latent)
    np.testing.assert_allclose(got["floor_transform"],
                               ref["floor_transform"], atol=1e-6)
    assert_meshes_match(
        got["vertices"], got["faces"], ref["vertices"], ref["faces"],
        exporter.tsdf_config.voxel_size,
        [(got[k], ref[k]) for k in ("colors", "normals", "features")])
    np.testing.assert_allclose(np.linalg.norm(got["normals"], axis=-1), 1.0,
                               atol=1e-4)


@pytest.mark.parametrize("cls", ["LevelSetExtractor",
                                 "MarchingCubesMeshExporter"])
def test_level_set_matches(cls):
    p = disk_scene(extra=30, seed=6, thickness=0.02)
    jp, ja, tp, ta = both_params(p)
    jm, tm = both_configs()
    ref = getattr(jexp, cls)(jp, ja, jm, level=0.3, resolution=32).main()
    got = getattr(texp, cls)(tp, ta, tm, level=0.3, resolution=32).main()
    voxel = float(((p["means"].max(0) - p["means"].min(0) + 0.2)
                   / 31).max())
    assert_meshes_match(got["vertices"], got["faces"], ref["vertices"],
                        ref["faces"], voxel, [(got["colors"], ref["colors"])])


# -- metrics -----------------------------------------------------------------

def test_metrics_match():
    from test_torch_core import numpy_scene

    p, K, c2w = numpy_scene(800, seed=9, width=96, height=64)
    jp, ja, tp, ta = both_params(p)
    jm, tm = both_configs()
    jcam, tcam = both_cameras(K, c2w, 96, 64)
    jproj = jax.jit(lambda p, a, c: jrade.get_outputs(
        p, a, c, 0, jm, training=False)[1].proj)(jp, ja, jcam)
    jmeta = JRenderMeta(jproj, None, 96, 64)
    _, tmeta = trade.get_outputs(tp, ta, tcam, 0, tm, training=False)
    ref, got = jmetrics.project_gaussians(jmeta), \
        tmetrics.project_gaussians(tmeta)
    for k in ("proj_flattened", "valid_mask", "gaussian_ids"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["proj_depths"], ref["proj_depths"],
                               rtol=1e-6)
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(500, 3)), rng.normal(size=(400, 3))
    assert tmetrics.calculate_accuracy(a, b) == \
        jmetrics.calculate_accuracy(a, b)
    assert tmetrics.calculate_completeness(a, b, 0.3) == \
        jmetrics.calculate_completeness(a, b, 0.3)
    n1 = rng.normal(size=(16, 16, 3)).astype(np.float32)
    n2 = rng.normal(size=(16, 16, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tmetrics.mean_angular_error(torch.from_numpy(n1),
                                    torch.from_numpy(n2)).numpy(),
        np.asarray(jmetrics.mean_angular_error(jnp.asarray(n1),
                                               jnp.asarray(n2))),
        rtol=0, atol=1e-6)

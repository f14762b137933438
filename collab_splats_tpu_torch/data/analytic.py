"""Analytic ray-traced ground truth: a target Gaussians cannot represent.

Counterpart of the JAX package's ``data/analytic.py``, the port's own copy.
Host numpy renders a closed-form scene of textured primitives:

* a checkered ground plane with fine stripe modulation,
* ~10 shaded spheres with per-sphere procedural textures,
* a striped cylindrical backdrop wall (so, like a real capture, nearly
  every ray hits something and a model cannot hide in alpha = 0),
* one directional light with hard sphere shadows, ambient + Lambertian
  diffuse + Blinn-Phong specular (view-dependent, so sh_degree 3 has a
  signal to fit).

Hard texture edges, hard shadows and specular lobes are outside the span
of anisotropic Gaussians, so a fit to these images measures how well the
renderer approximates, not only that the trainer optimizes.  The tracer
also returns world hit points and hit masks, which stand in for the SfM
sparse points a real pipeline seeds from.

Pure numpy (float64 inside, float32 out), vectorized over the pixels of
one camera.  Cameras are the port's :class:`~..core.cameras.Camera`; their
``K`` and ``c2w`` are read to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ..core.cameras import Camera

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class AnalyticScene:
    """Closed-form scene description (all numpy, world units)."""

    sphere_centers: np.ndarray      # [S, 3]
    sphere_radii: np.ndarray        # [S]
    sphere_colors_a: np.ndarray     # [S, 3] texture color A
    sphere_colors_b: np.ndarray     # [S, 3] texture color B
    sphere_freq: np.ndarray         # [S] texture cells around the equator
    plane_z: float = -0.7
    plane_radius: float = 4.2       # disk out to the wall
    wall_radius: float = 4.0
    wall_z: tuple = (-0.7, 3.0)
    light_dir: np.ndarray = dataclasses.field(
        default_factory=lambda: _norm(np.array([0.45, 0.25, 0.85]))
    )
    ambient: float = 0.30
    diffuse: float = 0.70
    specular: float = 0.55
    shininess: float = 48.0


def _norm(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True) \
        if v.ndim > 1 else v / np.linalg.norm(v)


def default_scene(seed: int = 7, n_spheres: int = 10) -> AnalyticScene:
    """The benchmark scene of the JAX package's ``scripts/scale_train.py``:
    deterministic given ``seed``."""
    rng = np.random.RandomState(seed)
    centers = []
    radii = []
    for _ in range(n_spheres):
        r = rng.uniform(0.18, 0.42)
        # Rejection-place so spheres don't overlap (bounded tries).
        for _ in range(200):
            c = np.array([
                rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5),
                -0.7 + r + rng.uniform(0.0, 0.7),
            ])
            if all(np.linalg.norm(c - p) > r + q + 0.05
                   for p, q in zip(centers, radii)):
                break
        centers.append(c)
        radii.append(r)
    # Distinct saturated hue pairs per sphere.
    hues = rng.uniform(0.15, 1.0, size=(n_spheres, 3))
    hues = hues / hues.max(axis=1, keepdims=True)
    alt = np.roll(hues, 1, axis=1) * rng.uniform(0.2, 0.6, (n_spheres, 1))
    freq = rng.randint(6, 14, size=n_spheres).astype(np.float64)
    return AnalyticScene(
        sphere_centers=np.asarray(centers, np.float64),
        sphere_radii=np.asarray(radii, np.float64),
        sphere_colors_a=hues.astype(np.float64),
        sphere_colors_b=alt.astype(np.float64),
        sphere_freq=freq,
    )


# --------------------------------------------------------------- textures
def _checker(u: np.ndarray, v: np.ndarray, size: float) -> np.ndarray:
    return ((np.floor(u / size) + np.floor(v / size)) % 2.0)


def _plane_albedo(p: np.ndarray) -> np.ndarray:
    """Checker + fine stripe modulation on the ground plane."""
    x, y = p[..., 0], p[..., 1]
    c = _checker(x, y, 0.3)[..., None]
    base = c * np.array([0.82, 0.78, 0.72]) + (1 - c) * np.array(
        [0.24, 0.30, 0.38]
    )
    fine = 0.12 * np.sin(21.0 * x) * np.sin(17.0 * y)
    rings = 0.08 * np.cos(9.0 * np.sqrt(x * x + y * y + 1e-9))
    return np.clip(base * (1.0 + fine[..., None] + rings[..., None]), 0, 1)


def _wall_albedo(p: np.ndarray) -> np.ndarray:
    """Angular stripes + height bands on the backdrop cylinder."""
    t = np.arctan2(p[..., 1], p[..., 0])
    z = p[..., 2]
    s = (np.sin(14.0 * t) > 0.0).astype(np.float64)[..., None]
    base = s * np.array([0.55, 0.62, 0.70]) + (1 - s) * np.array(
        [0.35, 0.38, 0.44]
    )
    band = 0.15 * np.sin(6.0 * z + 2.0 * t)[..., None]
    return np.clip(base * (1.0 + band), 0, 1)


def _sphere_albedo(n_obj: np.ndarray, scene: AnalyticScene,
                   sid: np.ndarray) -> np.ndarray:
    """Lat-long checker in the sphere's object frame."""
    u = np.arctan2(n_obj[..., 1], n_obj[..., 0])            # [-pi, pi]
    v = np.arccos(np.clip(n_obj[..., 2], -1.0, 1.0))        # [0, pi]
    f = scene.sphere_freq[sid]
    c = ((np.floor(u * f / np.pi) + np.floor(v * f / np.pi)) % 2.0)[..., None]
    a = scene.sphere_colors_a[sid]
    b = scene.sphere_colors_b[sid]
    return c * a + (1 - c) * b


# ------------------------------------------------------------ intersection
def _intersect(scene: AnalyticScene, origin: np.ndarray,
               dirs: np.ndarray) -> Dict[str, np.ndarray]:
    """Nearest hit of each ray.  origin [3], dirs [..., 3] (normalized).

    Returns t (inf when missed), object id (-1 miss, 0 plane, 1 wall,
    2+s sphere s), world points, shading normals.
    """
    sh = dirs.shape[:-1]
    t_best = np.full(sh, np.inf)
    obj = np.full(sh, -1, np.int64)

    # Ground plane z = plane_z, within disk.
    dz = dirs[..., 2]
    t_pl = np.where(np.abs(dz) > _EPS,
                    (scene.plane_z - origin[2]) / np.where(
                        np.abs(dz) > _EPS, dz, 1.0),
                    np.inf)
    p_pl = origin + t_pl[..., None] * dirs
    ok = (t_pl > _EPS) & (
        p_pl[..., 0] ** 2 + p_pl[..., 1] ** 2 <= scene.plane_radius ** 2
    )
    t_best = np.where(ok & (t_pl < t_best), t_pl, t_best)
    obj = np.where(ok & (t_pl <= t_best), 0, obj)

    # Backdrop cylinder x^2 + y^2 = R^2 (rays start inside: far root).
    a = dirs[..., 0] ** 2 + dirs[..., 1] ** 2
    b = 2.0 * (origin[0] * dirs[..., 0] + origin[1] * dirs[..., 1])
    c = origin[0] ** 2 + origin[1] ** 2 - scene.wall_radius ** 2
    disc = b * b - 4.0 * a * c
    sq = np.sqrt(np.maximum(disc, 0.0))
    a_safe = np.where(a > _EPS, a, 1.0)
    t_cyl = np.where((a > _EPS) & (disc > 0.0), (-b + sq) / (2.0 * a_safe),
                     np.inf)
    z_hit = origin[2] + t_cyl * dirs[..., 2]
    ok = (t_cyl > _EPS) & (z_hit >= scene.wall_z[0]) & (
        z_hit <= scene.wall_z[1]
    )
    better = ok & (t_cyl < t_best)
    t_best = np.where(better, t_cyl, t_best)
    obj = np.where(better, 1, obj)

    # Spheres (iterate: S ~ 10).
    for s in range(len(scene.sphere_radii)):
        oc = origin - scene.sphere_centers[s]
        b = 2.0 * np.einsum("...i,i->...", dirs, oc)
        c = oc @ oc - scene.sphere_radii[s] ** 2
        disc = b * b - 4.0 * c
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_s = np.where(disc > 0.0, (-b - sq) / 2.0, np.inf)
        t_s = np.where(t_s > _EPS, t_s, np.inf)
        better = t_s < t_best
        t_best = np.where(better, t_s, t_best)
        obj = np.where(better, 2 + s, obj)

    pts = origin + np.where(np.isfinite(t_best), t_best, 0.0)[..., None] \
        * dirs
    # Normals per object class.
    normal = np.zeros(sh + (3,))
    normal[..., 2] = 1.0                                     # plane default
    wall_n = -pts[..., :3].copy()
    wall_n[..., 2] = 0.0
    nw = _norm(np.where(np.linalg.norm(wall_n, axis=-1, keepdims=True)
                        > _EPS, wall_n, np.array([1.0, 0, 0])))
    normal = np.where((obj == 1)[..., None], nw, normal)
    for s in range(len(scene.sphere_radii)):
        ns = (pts - scene.sphere_centers[s]) / scene.sphere_radii[s]
        normal = np.where((obj == 2 + s)[..., None], ns, normal)
    return {"t": t_best, "obj": obj, "points": pts, "normal": normal}


def _shadowed(scene: AnalyticScene, pts: np.ndarray,
              skip_obj: np.ndarray) -> np.ndarray:
    """Hard shadow test toward the directional light (spheres occlude)."""
    sh = pts.shape[:-1]
    shadow = np.zeros(sh, bool)
    ld = scene.light_dir
    for s in range(len(scene.sphere_radii)):
        oc = pts - scene.sphere_centers[s]
        b = 2.0 * (oc @ ld)
        c = np.einsum("...i,...i->...", oc, oc) - scene.sphere_radii[s] ** 2
        disc = b * b - 4.0 * c
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_near = (-b - sq) / 2.0
        hit = (disc > 0.0) & (t_near > 1e-4) & (skip_obj != 2 + s)
        shadow |= hit
    return shadow


# ----------------------------------------------------------------- render
def render_analytic(scene: AnalyticScene, camera: Camera) -> Dict[str, np.ndarray]:
    """Ray-trace one camera.  Returns rgb [H,W,3] f32 in [0,1], world hit
    points [H,W,3] f32, hit mask [H,W] bool, z-depth [H,W] f32 (COLMAP
    camera-space z, inf where missed)."""
    K = camera.K.detach().cpu().numpy().astype(np.float64)
    c2w = camera.c2w.detach().cpu().numpy().astype(np.float64)
    w, h = camera.width, camera.height
    xs = (np.arange(w) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (np.arange(h) + 0.5 - K[1, 2]) / K[1, 1]
    gx, gy = np.meshgrid(xs, ys)                             # [H, W]
    # COLMAP pixel ray (x right, y down, z forward) -> OpenGL camera frame
    # (y up, z backward) -> world via the OpenGL c2w.
    d_gl = np.stack([gx, -gy, -np.ones_like(gx)], axis=-1)
    dirs = _norm(d_gl @ c2w[:3, :3].T)
    origin = c2w[:3, 3]

    hit = _intersect(scene, origin, dirs)
    obj, pts, nrm = hit["obj"], hit["points"], hit["normal"]
    missed = obj < 0

    albedo = np.zeros_like(pts)
    albedo = np.where((obj == 0)[..., None], _plane_albedo(pts), albedo)
    albedo = np.where((obj == 1)[..., None], _wall_albedo(pts), albedo)
    for s in range(len(scene.sphere_radii)):
        sel = obj == 2 + s
        if not sel.any():
            continue
        n_obj = (pts - scene.sphere_centers[s]) / scene.sphere_radii[s]
        albedo = np.where(sel[..., None],
                          _sphere_albedo(n_obj, scene,
                                         np.full(obj.shape, s)), albedo)

    ld = scene.light_dir
    ndotl = np.clip(np.einsum("...i,i->...", nrm, ld), 0.0, 1.0)
    lit = ~_shadowed(scene, pts, obj)
    diff = scene.ambient + scene.diffuse * ndotl * lit
    # Blinn-Phong specular (view-dependent).
    view = _norm(origin - pts)
    half = _norm(view + ld)
    spec_str = np.where(obj >= 2, scene.specular,
                        np.where(obj == 0, 0.15, 0.05))
    spec = spec_str * lit * np.clip(
        np.einsum("...i,...i->...", nrm, half), 0.0, 1.0
    ) ** scene.shininess
    rgb = np.clip(albedo * diff[..., None] + spec[..., None], 0.0, 1.0)
    rgb = np.where(missed[..., None], 0.0, rgb)

    # COLMAP camera-space z depth (for TSDF-style consumers).
    w2c_r = c2w[:3, :3].T
    cam_pts = (pts - origin) @ w2c_r.T
    z = -cam_pts[..., 2]                                     # OpenGL z back
    z = np.where(missed, np.inf, z)
    return {
        "rgb": rgb.astype(np.float32),
        "points": pts.astype(np.float32),
        "hit": ~missed,
        "depth": z.astype(np.float32),
    }


def seed_points_from_views(
    scene: AnalyticScene,
    cameras: Sequence[Camera],
    renders: Sequence[Dict[str, np.ndarray]],
    n_points: int,
    seed: int = 0,
    noise: float = 0.01,
) -> Dict[str, np.ndarray]:
    """SfM-like seed cloud: random surface pixels unprojected with color.

    Mirrors the reference's COLMAP-sparse-points initialization (Splatfacto
    seeds means from the sparse cloud and colors from the point colors).
    """
    rng = np.random.RandomState(seed)
    pts, cols = [], []
    per_cam = -(-n_points // len(renders))
    for r in renders:
        ok = np.argwhere(r["hit"])
        take = ok[rng.randint(0, len(ok), size=per_cam)]
        pts.append(r["points"][take[:, 0], take[:, 1]])
        cols.append(r["rgb"][take[:, 0], take[:, 1]])
    pts = np.concatenate(pts)[:n_points]
    cols = np.concatenate(cols)[:n_points]
    pts = pts + noise * rng.randn(*pts.shape).astype(np.float32)
    return {"points": pts.astype(np.float32),
            "colors": cols.astype(np.float32)}


def sample_gt_surface(scene: AnalyticScene, n_points: int,
                      seed: int = 0) -> np.ndarray:
    """Uniform-ish samples of the true scene surfaces (mesh-metric GT).

    The mesh evaluation measures an extracted mesh's accuracy and
    completeness against these exact surface samples (utils/metrics.py).
    """
    rng = np.random.RandomState(seed)
    areas = [np.pi * scene.plane_radius ** 2]
    areas.append(2 * np.pi * scene.wall_radius *
                 (scene.wall_z[1] - scene.wall_z[0]))
    areas += [4 * np.pi * r * r for r in scene.sphere_radii]
    areas = np.asarray(areas)
    counts = np.maximum((areas / areas.sum() * n_points).astype(int), 1)
    out: List[np.ndarray] = []
    # Plane disk.
    r = scene.plane_radius * np.sqrt(rng.uniform(size=counts[0]))
    th = rng.uniform(0, 2 * np.pi, size=counts[0])
    out.append(np.stack([r * np.cos(th), r * np.sin(th),
                         np.full(counts[0], scene.plane_z)], axis=1))
    # Wall.
    th = rng.uniform(0, 2 * np.pi, size=counts[1])
    z = rng.uniform(scene.wall_z[0], scene.wall_z[1], size=counts[1])
    out.append(np.stack([scene.wall_radius * np.cos(th),
                         scene.wall_radius * np.sin(th), z], axis=1))
    # Spheres.
    for s in range(len(scene.sphere_radii)):
        v = rng.randn(counts[2 + s], 3)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        out.append(scene.sphere_centers[s]
                   + scene.sphere_radii[s] * v)
    return np.concatenate(out).astype(np.float32)

"""Synthetic scenes: random Gaussians and orbit camera rigs.

Counterpart of the JAX package's ``data/synthetic.py``.  Draws come from an
explicit ``torch.Generator``; they differ from ``jax.random``'s, so tests
that compare the two packages build one scene with numpy and hand it to
both (``models/gaussians.py::params_from_numpy``).
:func:`write_synthetic_dataset` renders a scene to a dataset directory
that the pipeline takes in place of an SfM run.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.cameras import Camera, make_camera
from ..core.sh import num_sh_bases, rgb_to_sh0
from ..utils.device import resolve_device


def random_gaussian_params(
    generator: Optional[torch.Generator],
    n: int,
    sh_degree: int = 0,
    extent: float = 1.0,
    scale_range: tuple = (0.01, 0.05),
    latent_dim: int = 0,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Raw (pre-activation) Gaussian parameters in the reference layout.

    The draws run on the generator's device (the CPU for a default
    ``torch.Generator()``), so one seed gives one scene on every device;
    the result is moved to ``device`` (the card by default).
    """
    dev = resolve_device(device)
    gen_dev = generator.device if generator is not None else torch.device(
        "cpu")

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=gen_dev)
        return lo + (hi - lo) * u

    means = uniform((n, 3), -extent, extent)
    log_scales = torch.log(uniform((n, 3), scale_range[0], scale_range[1]))
    quats = torch.randn((n, 4), generator=generator, device=gen_dev)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opacities = uniform((n, 1), 0.5, 3.0)
    rgb = uniform((n, 3), 0.1, 0.9)
    rest = 0.01 * torch.randn((n, num_sh_bases(sh_degree) - 1, 3),
                              generator=generator, device=gen_dev)
    params = {
        "means": means,
        "scales": log_scales,
        "quats": quats,
        "opacities": opacities,
        "features_dc": rgb_to_sh0(rgb),
        "features_rest": rest,
    }
    if latent_dim:
        params["distill_features"] = torch.zeros((n, latent_dim))
    return {k: v.to(device=dev, dtype=torch.float32)
            for k, v in params.items()}


def look_at_c2w(eye: np.ndarray, target: np.ndarray, up=None) -> np.ndarray:
    """OpenGL camera-to-world [4, 4] looking from ``eye`` toward ``target``."""
    up = np.array([0.0, 0.0, 1.0]) if up is None else np.asarray(up, np.float64)
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    # OpenGL: x right, y up, z backward (-forward).
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def orbit_cameras(
    n_cams: int,
    radius: float = 3.0,
    width: int = 128,
    height: int = 128,
    focal: float | None = None,
    elevation: float = 0.4,
    target=(0.0, 0.0, 0.0),
    device=None,
) -> List[Camera]:
    """Cameras orbiting ``target`` -- the synthetic stand-in for SfM poses."""
    target = np.asarray(target, np.float64)
    focal = focal if focal is not None else 1.2 * max(width, height)
    cams = []
    for i in range(n_cams):
        ang = 2.0 * np.pi * i / max(n_cams, 1)
        eye = target + radius * np.array(
            [np.cos(ang), np.sin(ang), np.sin(elevation)])
        cams.append(make_camera(focal, focal, width / 2.0, height / 2.0,
                                width, height, look_at_c2w(eye, target),
                                device=device))
    return cams


def write_synthetic_dataset(
    out_dir,
    n_cams: int = 8,
    n_gaussians: int = 300,
    width: int = 64,
    height: int = 64,
    seed: int = 0,
    scene: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = None,
    model_config=None,
    device=None,
):
    """Render a Gaussian scene to a nerfstudio-format dataset.

    Writes ``transforms.json``, ``images/frame_XXXXX.png`` (the port's PNG
    codec) and ``sparse.ply`` (the scene's means with their SH0 colours):
    the contract the preprocessing stage (ns-process-data / COLMAP) would
    produce, so the pipeline runs with no SfM.  By default the scene is
    ``random_gaussian_params`` drawn from ``torch.Generator`` seeded with
    ``seed`` (not the JAX package's draws), rendered black-background at
    sh_degree 0 from ``n_cams`` orbit cameras at radius 2.5.

    ``scene`` gives (raw params, alive) to render instead, with
    ``model_config`` (a ``RadeGSConfig``) for its render.  Renders run on
    ``device`` (the card by default).

    Returns (out_dir, params, cameras).
    """
    import json
    from pathlib import Path

    from ..core.options import RenderOptions
    from ..core.sh import sh0_to_rgb
    from ..models import rade_gs
    from .ply import write_ply
    from .png import write_png

    dev = resolve_device(device)
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    if scene is None:
        gt = random_gaussian_params(torch.Generator().manual_seed(seed),
                                    n_gaussians, extent=0.6,
                                    scale_range=(0.02, 0.08), device=dev)
        alive = torch.ones(n_gaussians, dtype=torch.bool, device=dev)
    else:
        gt, alive = scene
    if model_config is None:
        model_config = rade_gs.RadeGSConfig(
            sh_degree=0, background="black",
            render=RenderOptions(tile_capacity=256,
                                 max_intersections=1 << 16))
    focal = 1.1 * max(width, height)
    cams = orbit_cameras(n_cams, radius=2.5, width=width, height=height,
                         focal=focal, device=dev)
    frames = []
    with torch.no_grad():
        for i, cam in enumerate(cams):
            out, _ = rade_gs.get_outputs(gt, alive, cam, 0, model_config,
                                         training=False)
            img = (torch.clamp(out["rgb"], 0, 1) * 255).to(torch.uint8)
            name = f"images/frame_{i:05d}.png"
            write_png(out_dir / name, img.cpu().numpy())
            frames.append({
                "file_path": name,
                "transform_matrix": cam.c2w.cpu().numpy().astype(
                    np.float64).tolist(),
            })
        means = gt["means"][alive]
        colors = torch.clamp(sh0_to_rgb(gt["features_dc"][alive]), 0, 1)
        means, colors = means.cpu().numpy(), colors.cpu().numpy()
    meta = {
        "fl_x": float(focal), "fl_y": float(focal),
        "cx": width / 2.0, "cy": height / 2.0,
        "w": width, "h": height,
        "camera_model": "OPENCV",
        "ply_file_path": "sparse.ply",
        "frames": frames,
    }
    with open(out_dir / "transforms.json", "w") as f:
        json.dump(meta, f)
    write_ply(str(out_dir / "sparse.ply"), means, colors=colors)
    return out_dir, gt, cams


def flat_disk_gaussian(center=(0.0, 0.0, 0.0), normal=(0.0, 0.0, 1.0),
                       radius=0.3, thickness=1e-3,
                       device=None) -> Dict[str, torch.Tensor]:
    """One flat disk Gaussian with a known geometric normal: raw
    parameters with scales (radius, radius, thickness) and the rotation
    whose z-axis is ``normal``, as the JAX package's function builds it."""
    dev = resolve_device(device)
    normal = np.asarray(normal, np.float64)
    normal = normal / np.linalg.norm(normal)
    # Build rotation with z-axis = normal, convert to wxyz quaternion.
    helper = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(helper, normal)) > 0.9:
        helper = np.array([0.0, 1.0, 0.0])
    x = np.cross(helper, normal)
    x = x / np.linalg.norm(x)
    y = np.cross(normal, x)
    R = np.stack([x, y, normal], axis=1)
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2.0
    quat = np.array([
        w,
        (R[2, 1] - R[1, 2]) / (4 * w),
        (R[0, 2] - R[2, 0]) / (4 * w),
        (R[1, 0] - R[0, 1]) / (4 * w),
    ])

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return {
        "means": f32([center]),
        "scales": torch.log(f32([[radius, radius, thickness]])),
        "quats": f32([quat]),
        "opacities": f32([[4.0]]),   # sigmoid(4) ~ 0.982
        "features_dc": rgb_to_sh0(f32([[0.8, 0.2, 0.2]])),
        "features_rest": torch.zeros((1, 0, 3), dtype=torch.float32,
                                     device=dev),
    }

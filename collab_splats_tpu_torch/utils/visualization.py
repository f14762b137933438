"""Visualization: splat and mesh renders to images, and camera frusta.

Counterpart of the JAX package's ``utils/visualization.py`` (the
reference's ``visualize_splat`` and PyVista camera frusta).  The renderer
is the visualizer: splats are drawn by the model's own tiled rasterizer on
the parameters' device, under ``torch.no_grad``; meshes by a minimal
z-buffer triangle painter on the host (numpy); figures are assembled with
matplotlib, imported inside :func:`save_figure` only.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.cameras import Camera
from ..models import rade_gs
from ..models.gaussians import GaussianParams


@torch.no_grad()
def visualize_splat(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    model_config: Optional[rade_gs.RadeGSConfig] = None,
    mode: str = "rgb",
) -> np.ndarray:
    """Render one view of the splat for figures.

    ``mode``: rgb | depth | median_depth | normals | accumulation.
    Returns [H, W, 3] float32 in [0, 1] on the host.
    """
    cfg = model_config or rade_gs.RadeGSConfig(sh_degree=0,
                                               background="black")
    out, _ = rade_gs.get_outputs(params, alive, camera, 0, cfg,
                                 training=False)
    if mode == "rgb":
        img = out["rgb"]
    elif mode in ("depth", "median_depth"):
        d = out[mode]
        d = (d - d.min()) / torch.clamp(d.max() - d.min(), min=1e-9)
        img = torch.stack([d] * 3, dim=-1)
    elif mode == "normals":
        img = out["normals"]
    elif mode == "accumulation":
        img = torch.stack([out["accumulation"]] * 3, dim=-1)
    else:
        raise ValueError(f"unknown mode {mode}")
    return np.clip(img.cpu().numpy(), 0.0, 1.0)


def camera_frustum_lines(camera: Camera, scale: float = 0.1) -> np.ndarray:
    """Frustum wireframe segments [(P0, P1), ...] in world space, [E, 2, 3]:
    apex at the camera centre, four rays through the image corners at
    ``scale`` depth (the reference's PyVista frusta)."""
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    w, h = camera.width, camera.height
    corners_px = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    # OpenGL camera: x right, y up, z backward; pixel y runs down.
    dirs = np.stack([
        (corners_px[:, 0] - cx) / fx,
        -(corners_px[:, 1] - cy) / fy,
        -np.ones(4),
    ], axis=-1) * scale
    c2w = camera.c2w.detach().cpu().numpy()
    apex = c2w[:3, 3]
    pts = dirs @ c2w[:3, :3].T + apex
    segs = []
    for i in range(4):
        segs.append([apex, pts[i]])
        segs.append([pts[i], pts[(i + 1) % 4]])
    return np.asarray(segs)


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray,
    camera: Camera,
    background: float = 1.0,
) -> np.ndarray:
    """Minimal z-buffered flat-shaded mesh render, [H, W, 3] in [0, 1]."""
    h, w = camera.height, camera.width
    w2c = camera.viewmat().detach().cpu().numpy()
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    p_cam = vertices @ w2c[:3, :3].T + w2c[:3, 3]
    z = p_cam[:, 2]
    u = fx * p_cam[:, 0] / np.clip(z, 1e-6, None) + cx
    v = fy * p_cam[:, 1] / np.clip(z, 1e-6, None) + cy

    img = np.full((h, w, 3), background, np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    fcol = colors[faces].mean(axis=1)
    fz = z[faces].mean(axis=1)
    order = np.argsort(-fz)  # painter fallback inside the z-test loop
    for fi in order:
        i0, i1, i2 = faces[fi]
        if z[i0] <= 0 or z[i1] <= 0 or z[i2] <= 0:
            continue
        us, vs = [u[i] for i in (i0, i1, i2)], [v[i] for i in (i0, i1, i2)]
        x0, x1 = int(max(min(us), 0)), int(min(max(us), w - 1))
        y0, y1 = int(max(min(vs), 0)), int(min(max(vs), h - 1))
        if x1 < x0 or y1 < y0:
            continue
        img[y0:y1 + 1, x0:x1 + 1] = np.where(
            (fz[fi] < zbuf[y0:y1 + 1, x0:x1 + 1])[..., None],
            fcol[fi], img[y0:y1 + 1, x0:x1 + 1])
        zbuf[y0:y1 + 1, x0:x1 + 1] = np.minimum(
            zbuf[y0:y1 + 1, x0:x1 + 1], fz[fi])
    return np.clip(img, 0, 1)


def save_figure(images: Dict[str, np.ndarray], path: str,
                cols: int = 3) -> None:
    """Save a labelled grid of images (matplotlib, imported here)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows),
                             squeeze=False)
    for ax in axes.reshape(-1):
        ax.axis("off")
    for ax, (name, img) in zip(axes.reshape(-1), images.items()):
        ax.imshow(img)
        ax.set_title(name)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)

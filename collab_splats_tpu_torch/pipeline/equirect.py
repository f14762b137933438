"""Equirectangular (360) input support.

Counterpart of the JAX package's ``pipeline/equirect.py``, an own copy.
The reference forwards 360 inputs to nerfstudio's ``ns-process-data images
--camera-type equirectangular --images-per-equirect 14``, which crops each
panorama into 14 perspective views and runs ordinary SfM on them.  Same
contract here: each equirect frame is resampled into 14 pinhole crops (8
around the horizon at 45 degree yaw steps, 4 at +-45 degree pitch on 90
degree yaw steps, zenith, nadir; 90 degree FOV each) which then feed the
COLMAP runner like any other image set.  PIL is imported inside
:func:`crop_equirect_dir` only.
"""


from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

# (yaw_deg, pitch_deg) of the 14 crops.
VIEW_DIRECTIONS: List[Tuple[float, float]] = (
    [(45.0 * i, 0.0) for i in range(8)]
    + [(90.0 * i, 45.0) for i in range(2)]
    + [(90.0 * i, -45.0) for i in range(2)]
    + [(0.0, 90.0), (0.0, -90.0)]
)


def equirect_to_perspective(
    pano: np.ndarray,
    yaw_deg: float,
    pitch_deg: float,
    fov_deg: float = 90.0,
    out_size: int | None = None,
) -> np.ndarray:
    """Resample one pinhole view out of an equirect panorama.

    Args:
        pano: [H, W, C] equirectangular image (yaw spans [-pi, pi] over W,
            pitch spans [+pi/2, -pi/2] over H).
        yaw_deg, pitch_deg: view direction.
        fov_deg: horizontal = vertical field of view of the square crop.
        out_size: crop resolution (defaults to H // 2).

    Returns:
        [out_size, out_size, C] perspective image (bilinear sampling).
    """
    h, w = pano.shape[:2]
    s = out_size or h // 2
    f = 0.5 * s / np.tan(np.radians(fov_deg) / 2)

    # Camera rays in view space (x right, y down, z forward).
    u = (np.arange(s) + 0.5 - s / 2) / f
    v = (np.arange(s) + 0.5 - s / 2) / f
    uu, vv = np.meshgrid(u, v)
    dirs = np.stack([uu, vv, np.ones_like(uu)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    yaw = np.radians(yaw_deg)
    pitch = np.radians(pitch_deg)
    # pitch: rotate about x (look up for positive pitch); then yaw about
    # the world up axis.
    rx = np.array([
        [1, 0, 0],
        [0, np.cos(pitch), -np.sin(pitch)],
        [0, np.sin(pitch), np.cos(pitch)],
    ])
    ry = np.array([
        [np.cos(yaw), 0, np.sin(yaw)],
        [0, 1, 0],
        [-np.sin(yaw), 0, np.cos(yaw)],
    ])
    d = dirs @ (ry @ rx).T

    lon = np.arctan2(d[..., 0], d[..., 2])         # [-pi, pi]
    lat = np.arcsin(np.clip(-d[..., 1], -1, 1))    # [-pi/2, pi/2], up +
    x = (lon / (2 * np.pi) + 0.5) * w - 0.5
    y = (0.5 - lat / np.pi) * h - 0.5

    # Bilinear sample with horizontal wrap, vertical clamp.
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0w, x1w = x0 % w, (x0 + 1) % w
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    p = pano.astype(np.float32)
    out = (
        p[y0c, x0w] * (1 - fx) * (1 - fy)
        + p[y0c, x1w] * fx * (1 - fy)
        + p[y1c, x0w] * (1 - fx) * fy
        + p[y1c, x1w] * fx * fy
    )
    return out.astype(pano.dtype if pano.dtype == np.uint8 else np.float32)


def generate_planar_projections(
    pano: np.ndarray, fov_deg: float = 90.0, out_size: int | None = None
) -> List[np.ndarray]:
    """All 14 perspective crops of one panorama."""
    return [
        equirect_to_perspective(pano, yaw, pitch, fov_deg, out_size)
        for yaw, pitch in VIEW_DIRECTIONS
    ]


def crop_equirect_dir(src_dir: Path, dst_dir: Path,
                      fov_deg: float = 90.0) -> int:
    """Crop every panorama image in ``src_dir`` into ``dst_dir``; returns
    the number of crops written."""
    from PIL import Image

    dst_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    exts = {".jpg", ".jpeg", ".png"}
    for img_path in sorted(Path(src_dir).iterdir()):
        if img_path.suffix.lower() not in exts:
            continue
        pano = np.asarray(Image.open(img_path).convert("RGB"))
        for j, crop in enumerate(generate_planar_projections(pano, fov_deg)):
            out = dst_dir / f"{img_path.stem}_v{j:02d}.png"
            Image.fromarray(crop.astype(np.uint8)).save(out)
            n += 1
    return n

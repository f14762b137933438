"""``transforms.json`` dataparser: the structure-from-motion output contract.

Counterpart of the JAX package's ``data/dataparser.py`` (nerfstudio's
``NerfstudioDataParser`` as the reference uses it, with
``load_3D_points=True``): parse the ``transforms.json`` the preprocessing
stage writes, build the cameras, apply the standard pose normalization
(auto-orient "up", centre, scale into the unit box), split train/eval, and
load the point cloud for initialization.  The parsing is numpy; the
cameras are made on the device the caller names (the card by default).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..core.cameras import Camera, make_camera
from .ply import read_ply
from .png import read_png


@dataclasses.dataclass
class ParsedScene:
    train_cameras: List[Camera]
    eval_cameras: List[Camera]
    train_image_paths: List[Path]
    eval_image_paths: List[Path]
    points: Optional[np.ndarray]         # [N, 3] normalized world
    point_colors: Optional[np.ndarray]   # [N, 3] in [0, 1]
    transform: np.ndarray                # [4, 4] applied world transform
    scale: float                         # applied scale factor
    scene_scale: float                   # camera extent after normalization


def _auto_orient_and_center(poses: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate the average up vector to +z and centre on the mean camera
    origin (nerfstudio ``auto_orient_and_center_poses(method="up")``)."""
    up = poses[:, :3, 1].mean(axis=0)
    up /= np.linalg.norm(up) + 1e-12
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(up, z)
    s = np.linalg.norm(v)
    c = float(np.dot(up, z))
    if s < 1e-8:
        R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array(
            [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
    center = R @ poses[:, :3, 3].mean(axis=0)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -center
    return T, T[None] @ poses


def parse_transforms_json(
    path: str | Path,
    downscale_factor: int = 1,
    train_split_fraction: float = 0.9,
    auto_scale: bool = True,
    orient_center: bool = True,
    device=None,
) -> ParsedScene:
    """Parse a nerfstudio-format ``transforms.json``."""
    path = Path(path)
    root = path.parent
    with open(path) as f:
        meta = json.load(f)

    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    poses, intrinsics, image_paths = [], [], []
    for fr in frames:
        m = np.asarray(fr["transform_matrix"], np.float64)
        if m.shape == (3, 4):
            m = np.vstack([m, [0, 0, 0, 1.0]])
        poses.append(m)
        intr = {k: fr.get(k, meta.get(k))
                for k in ("fl_x", "fl_y", "cx", "cy", "w", "h")}
        if any(v is None for v in intr.values()):
            raise ValueError(f"missing intrinsics for frame {fr['file_path']}")
        intrinsics.append(intr)
        image_paths.append(root / fr["file_path"])
    poses = np.stack(poses)

    transform = np.eye(4)
    if orient_center:
        transform, poses = _auto_orient_and_center(poses)
    scale = 1.0
    if auto_scale:
        scale = float(1.0 / max(np.abs(poses[:, :3, 3]).max(), 1e-8))
        poses[:, :3, 3] *= scale

    f_d = float(downscale_factor)
    cameras = [
        make_camera(
            intr["fl_x"] / f_d, intr["fl_y"] / f_d,
            intr["cx"] / f_d, intr["cy"] / f_d,
            # Floor division, as load_image resizes: odd sizes would
            # otherwise give a camera and an image of different shapes.
            int(intr["w"]) // downscale_factor,
            int(intr["h"]) // downscale_factor,
            poses[i].astype(np.float32), device=device)
        for i, intr in enumerate(intrinsics)
    ]

    # Evenly spaced eval split (nerfstudio train_split_fraction semantics).
    n = len(cameras)
    n_train = int(np.ceil(n * train_split_fraction))
    if n_train >= n:
        train_idx = np.arange(n)
        eval_idx = np.array([], np.int64)
    else:
        eval_idx = np.linspace(0, n - 1, n - n_train).round().astype(np.int64)
        eval_idx = np.unique(eval_idx)
        train_idx = np.setdiff1d(np.arange(n), eval_idx)

    points = colors = None
    ply_path = meta.get("ply_file_path")
    if ply_path and (root / ply_path).exists():
        ply = read_ply(str(root / ply_path))
        pts = ply["points"].astype(np.float64)
        pts = pts @ transform[:3, :3].T + transform[:3, 3]
        points = (pts * scale).astype(np.float32)
        colors = ply.get("colors")

    return ParsedScene(
        train_cameras=[cameras[i] for i in train_idx],
        eval_cameras=[cameras[i] for i in eval_idx],
        train_image_paths=[image_paths[i] for i in train_idx],
        eval_image_paths=[image_paths[i] for i in eval_idx],
        points=points,
        point_colors=colors,
        transform=transform,
        scale=scale,
        scene_scale=float(np.abs(poses[:, :3, 3]).max()),
    )


def load_image(path: str | Path, downscale_factor: int = 1) -> np.ndarray:
    """An image as float32 [H, W, 3] in [0, 1] (PIL, imported here)."""
    return load_image_uint8(path, downscale_factor).astype(np.float32) / 255.0


def load_image_uint8(path: str | Path,
                     downscale_factor: int = 1) -> np.ndarray:
    """An image as uint8 [H, W, 3], bilinearly resized to floor-divided
    sizes when ``downscale_factor`` > 1.

    A PNG at full size is read by the port's own codec (``data/png.py``),
    so a run needs no image library; PIL reads other formats and
    downscaled loads (its BILINEAR resize), imported here."""
    if downscale_factor <= 1 and Path(path).suffix.lower() == ".png":
        img = read_png(path)
        if img.shape[2] == 1:               # greyscale, as convert("RGB")
            return np.repeat(img, 3, axis=2)
        return np.ascontiguousarray(img[..., :3])
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if downscale_factor > 1:
        img = img.resize((img.width // downscale_factor,
                          img.height // downscale_factor), Image.BILINEAR)
    return np.asarray(img, np.uint8)

"""Full-image datamanager: cached images and a per-step (camera, batch)
feed.

Counterpart of the JAX package's ``data/datamanager.py`` (nerfstudio's
``FullImageDatamanager`` with ``cache_images_type="uint8"``): every image
is decoded once into a uint8 cache, and one full image and its camera are
served per step.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.cameras import Camera
from .dataparser import load_image_uint8, parse_transforms_json


@dataclasses.dataclass
class FullImageDatamanager:
    train_cameras: List[Camera]
    eval_cameras: List[Camera]
    train_images: List[np.ndarray]     # uint8 [H, W, 3]
    eval_images: List[np.ndarray]
    points: Optional[np.ndarray] = None
    point_colors: Optional[np.ndarray] = None
    scene_scale: float = 1.0

    @classmethod
    def from_transforms_json(
        cls,
        path: str | Path,
        downscale_factor: int = 1,
        train_split_fraction: float = 0.9,
        device=None,
    ) -> "FullImageDatamanager":
        """Parse ``transforms.json`` (cameras on ``device``, the card by
        default) and decode its images into the uint8 cache."""
        scene = parse_transforms_json(path, downscale_factor,
                                      train_split_fraction, device=device)
        return cls(
            train_cameras=scene.train_cameras,
            eval_cameras=scene.eval_cameras,
            train_images=[load_image_uint8(p, downscale_factor)
                          for p in scene.train_image_paths],
            eval_images=[load_image_uint8(p, downscale_factor)
                         for p in scene.eval_image_paths],
            points=scene.points,
            point_colors=scene.point_colors,
            scene_scale=scene.scene_scale,
        )

    def __len__(self) -> int:
        return len(self.train_cameras)

    def next_train(self, step: int, rng: np.random.RandomState) -> Tuple[
            Camera, Dict[str, np.ndarray], int]:
        idx = int(rng.randint(len(self.train_cameras)))
        return self.train_cameras[idx], self._batch(self.train_images[idx]), \
            idx

    def next_eval(self, idx: int) -> Tuple[Camera, Dict[str, np.ndarray]]:
        return self.eval_cameras[idx], self._batch(self.eval_images[idx])

    @staticmethod
    def _batch(image: np.ndarray) -> Dict[str, np.ndarray]:
        return {"image": image.astype(np.float32) / 255.0}

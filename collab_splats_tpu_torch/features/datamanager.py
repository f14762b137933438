"""Feature-splatting datamanager: extract once, cache, serve per-camera
feature maps.

Counterpart of the JAX package's ``features/datamanager.py`` (the
reference's ``FeatureSplattingDataManager``):

* at setup, every configured extractor runs over every training image once,
  and each map is resized to a bounded long edge (``final_resolution``,
  default 64) with JAX's antialiased linear resize;
* the maps are cached on disk under a key of the image names, the
  extractor variants and the resolution.  The file name and the npz keys
  are the JAX package's, so either package reads the other's cache;
* ``next_train`` serves ``features_dict`` (branch -> [C, h, w]) with each
  image, and ``metadata`` the ``feature_type`` / ``feature_dims`` the model
  consumes.

The extractors and the maps live on the datamanager's ``device``, the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.datamanager import FullImageDatamanager
from ..utils.device import resolve_device
from .decoder import resize_bilinear
from .extractors import BaseExtractor, get_extractor


@dataclasses.dataclass
class FeatureDatamanagerConfig:
    feature_type: str = "clip-vit"          # the main (queryable) branch
    extractors: Tuple[str, ...] = ("clip-vit", "dinov2")
    final_resolution: int = 64              # cap on feature-map long edge
    cache_dir: Optional[str] = None

    def __post_init__(self):
        # Accept a comma-separated string (dot-notation CLI overrides).
        if isinstance(self.extractors, str):
            self.extractors = tuple(
                s.strip() for s in self.extractors.split(",") if s.strip()
            )


def _resize_chw(feat: torch.Tensor, max_edge: int) -> torch.Tensor:
    """[C, h, w] with its long edge brought down to ``max_edge`` (JAX's
    antialiased linear resize); a smaller map is returned as it is."""
    _, h, w = feat.shape
    scale = max_edge / max(h, w)
    if scale >= 1.0:
        return feat
    th, tw = max(int(h * scale), 1), max(int(w * scale), 1)
    return resize_bilinear(feat, (th, tw), axes=(1, 2))


class FeatureDatamanager(FullImageDatamanager):
    """FullImageDatamanager + per-image feature maps."""

    def __init__(self, base: FullImageDatamanager,
                 config: FeatureDatamanagerConfig,
                 image_names: Optional[Sequence[str]] = None,
                 device=None):
        super().__init__(**base.__dict__)
        self.device = resolve_device(device)
        self.feature_config = config
        self._extractors: Dict[str, BaseExtractor] = {
            name: get_extractor(name, device=self.device)
            for name in config.extractors
        }
        self.image_names = list(image_names or
                                [str(i) for i in range(len(self.train_images))])
        self.train_features: List[Dict[str, torch.Tensor]] = []
        self.feature_dims: Dict[str, Tuple[int, int, int]] = {}
        self._setup_features()

    # ------------------------------------------------------------- caching
    def _cache_path(self) -> Optional[Path]:
        if self.feature_config.cache_dir is None:
            return None
        # The key names the extractor *variant*, not just its name: a
        # weights file flips an extractor from the offline stand-in to the
        # released tower (other widths and values).
        variants = sorted(
            (name, bool(getattr(ext, "pretrained", False)),
             int(getattr(ext, "feature_dim", 0)))
            for name, ext in self._extractors.items()
        )
        key = hashlib.sha256(
            json.dumps(
                [self.image_names, variants,
                 self.feature_config.final_resolution]
            ).encode()
        ).hexdigest()[:16]
        d = Path(self.feature_config.cache_dir)
        d.mkdir(parents=True, exist_ok=True)
        return d / f"features_{self.feature_config.feature_type}_{key}.npz"

    def _setup_features(self):
        cache = self._cache_path()
        if cache is not None and cache.exists():
            with np.load(cache, allow_pickle=False) as data:
                self.train_features = [
                    {name: torch.tensor(data[f"{name}_{i}"],
                                        device=self.device)
                     for name in self.feature_config.extractors}
                    for i in range(len(self.train_images))
                ]
        else:
            self.train_features = []
            for img in self.train_images:
                fmap = {}
                for name, ext in self._extractors.items():
                    f = ext(np.asarray(img, np.float32) / 255.0)
                    fmap[name] = _resize_chw(
                        f.to(self.device, torch.float32),
                        self.feature_config.final_resolution).contiguous()
                self.train_features.append(fmap)
            if cache is not None:
                np.savez_compressed(cache, **{
                    f"{name}_{i}": fm[name].cpu().numpy()
                    for i, fm in enumerate(self.train_features)
                    for name in fm
                })
        self.feature_dims = {
            name: tuple(self.train_features[0][name].shape)
            for name in self.feature_config.extractors
        }

    # ------------------------------------------------------------- serving
    def next_train(self, step: int, rng: np.random.RandomState):
        idx = int(rng.randint(len(self.train_cameras)))
        batch = self._batch(self.train_images[idx])
        batch["features_dict"] = self.train_features[idx]
        return self.train_cameras[idx], batch, idx

    def metadata(self) -> Dict:
        """The metadata dict the features model consumes."""
        return {
            "feature_type": self.feature_config.feature_type,
            "feature_dims": self.feature_dims,
        }

    def text_encoder(self) -> Optional[BaseExtractor]:
        return self._extractors.get(self.feature_config.feature_type)

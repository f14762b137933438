"""Feature extractors: a name -> extractor registry and the ViT encoders.

Counterpart of the JAX package's ``features/extractors.py``: "clip-vit"
(also "samclip") gives MaskCLIP patch features and has a text encoder,
"dinov2" DINOv2 patch features, and "hash-proj" a deterministic stand-in
made of pooled colour statistics, host numpy as in JAX.  The feature
datamanager runs them over every training image at setup.

The ViT extractors run on their ``device``, the card unless the caller
passes ``device="cpu"``, and return [C, h, w] float32 tensors there.  With
a converted weights file (``weights_npz``, or found by
``features/weights.py``) they run the released towers (``pretrained``);
without one, the same architectures at reduced width from seeded
``torch.Generator``s, whose values differ from JAX's ``PRNGKey`` ones.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from . import vit
from .decoder import resize_bilinear
from .weights import find_weights

_REGISTRY: Dict[str, Callable[..., "BaseExtractor"]] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


@functools.lru_cache(maxsize=None)
def _default_extractor(name: str, device: Optional[str]) -> "BaseExtractor":
    cls = _REGISTRY[name]
    if "device" in {f.name for f in dataclasses.fields(cls)}:
        return cls(device=device)
    return cls()


def get_extractor(name: str, **kw) -> "BaseExtractor":
    """The extractor registered as ``name``.  With no arguments but
    ``device``, one instance per (name, device) is kept: a released CLIP
    tower is about 1.7 GB to read and upload."""
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown extractor '{name}'. Available: {sorted(_REGISTRY)}"
        )
    if set(kw) <= {"device"}:
        device = kw.get("device")
        return _default_extractor(
            name, None if device is None else str(torch.device(device)))
    return _REGISTRY[name](**kw)


def available_extractors():
    return sorted(_REGISTRY)


class BaseExtractor:
    """Extractor interface: image [H, W, 3] in [0, 1] -> features [C, h, w]."""

    feature_dim: int = 0
    patch_size: int = 14

    def __call__(self, image) -> torch.Tensor:
        raise NotImplementedError

    def encode_text(self, texts) -> Optional[torch.Tensor]:
        """[N, C] unit embeddings, or None if no text tower."""
        return None


def _prep_image(image, resolution, patch_size, mean, std, device):
    """Resize the longest edge to ``resolution``, snap to patch multiples,
    normalise; returns (img [th, tw, 3] on ``device``, ph, pw).

    The JAX package's two stages, which follow the reference's chain (a
    PIL bilinear longest-edge resize, then ``F.interpolate(bilinear)`` to
    patch multiples): the first antialiases, the second does not."""
    img = torch.as_tensor(np.asarray(image, np.float32), device=device)
    h, w = img.shape[:2]
    scale = resolution / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    th = max(nh // patch_size, 1) * patch_size
    tw = max(nw // patch_size, 1) * patch_size
    x = resize_bilinear(img, (nh, nw), antialias=True)
    if (nh, nw) != (th, tw):
        x = resize_bilinear(x, (th, tw), antialias=False)
    mean = torch.tensor(mean, dtype=torch.float32, device=device)
    std = torch.tensor(std, dtype=torch.float32, device=device)
    return (x - mean) / std, th // patch_size, tw // patch_size


@register("dinov2")
@dataclasses.dataclass
class DINOv2Extractor(BaseExtractor):
    """DINOv2 patch features (torchhub ``dinov2_vits14`` at resolution 800,
    ``x_norm_patchtokens``).  With ``dinov2_vits14.npz`` it runs the
    released 12-block ViT-S/14; offline the same architecture with
    ``offline_blocks`` random blocks."""

    feature_dim: int = 384
    patch_size: int = 14
    num_heads: int = 6
    resolution: int = 800
    offline_blocks: int = 4
    weights_npz: Optional[str] = None
    mean: Tuple[float, ...] = (0.5, 0.5, 0.5)
    std: Tuple[float, ...] = (0.5, 0.5, 0.5)
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        path = self.weights_npz or find_weights("dinov2_vits14.npz")
        if path:
            self.params = vit.load_params(path, self.device)
            self.pretrained = True
            # Width and heads from the checkpoint (head_dim is 64 for
            # every released DINOv2 size).
            ckpt_dim = int(self.params["cls_token"].shape[-1])
            if ckpt_dim != self.feature_dim:
                self.feature_dim = ckpt_dim
                self.num_heads = max(ckpt_dim // 64, 1)
        else:
            self.params = vit.init_dinov2_params(
                torch.Generator().manual_seed(0), self.feature_dim,
                self.offline_blocks, self.patch_size, device=self.device)
            self.pretrained = False

    @torch.no_grad()
    def __call__(self, image) -> torch.Tensor:
        img, ph, pw = _prep_image(image, self.resolution, self.patch_size,
                                  self.mean, self.std, self.device)
        feats = vit.dinov2_forward(self.params, img, self.num_heads,
                                   self.patch_size)
        return feats.reshape(ph, pw, -1).permute(2, 0, 1).contiguous()


@register("clip-vit")
@register("samclip")
@dataclasses.dataclass
class MaskCLIPExtractor(BaseExtractor):
    """MaskCLIP dense CLIP features and the CLIP text tower (maskclip_onnx
    "ViT-L/14@336px" at resolution 1024).  With ``clip_vitl14_336.npz`` it
    runs the released 24-block visual tower with the MaskCLIP head and the
    12-block text tower (BPE tokenizer gated on the CLIP vocabulary file);
    offline both towers at reduced width and depth, and text falls back to
    seeded unit vectors."""

    feature_dim: int = 768      # the joint embedding (what is consumed)
    patch_size: int = 14
    resolution: int = 1024
    weights_npz: Optional[str] = None
    offline_width: int = 192
    offline_blocks: int = 3
    mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        path = self.weights_npz or find_weights("clip_vitl14_336.npz")
        if path:
            self.params = vit.load_params(path, self.device)
            self.pretrained = True
            self.num_heads = self.params["visual.ln_pre.scale"].shape[0] // 64
            self.text_heads = \
                self.params["text.ln_final.scale"].shape[0] // 64
            self.feature_dim = int(self.params["visual.proj"].shape[1])
        else:
            w = self.offline_width
            self.params = {
                **vit.init_clip_visual_params(
                    torch.Generator().manual_seed(0), dim=w,
                    n_blocks=self.offline_blocks,
                    patch_size=self.patch_size, embed_dim=self.feature_dim,
                    device=self.device),
                **vit.init_clip_text_params(
                    torch.Generator().manual_seed(1), dim=w,
                    n_blocks=self.offline_blocks, vocab=512,
                    embed_dim=self.feature_dim, device=self.device),
            }
            self.pretrained = False
            self.num_heads = max(w // 64, 1)
            self.text_heads = max(w // 64, 1)

    @torch.no_grad()
    def __call__(self, image) -> torch.Tensor:
        img, ph, pw = _prep_image(image, self.resolution, self.patch_size,
                                  self.mean, self.std, self.device)
        feats = vit.maskclip_forward(self.params, img, self.num_heads,
                                     self.patch_size)
        return feats.reshape(ph, pw, -1).permute(2, 0, 1).contiguous()

    @torch.no_grad()
    def encode_text(self, texts) -> torch.Tensor:
        """[N, E] unit embeddings on the extractor's device: the text tower
        over the BPE ids when the weights and the vocabulary are there,
        else a seeded unit vector per text (a ``torch.Generator`` keyed by
        the text's SHA-256, so not JAX's vector)."""
        from .clip_tokenizer import get_tokenizer

        tok = get_tokenizer() if self.pretrained else None
        out = []
        for t in texts:
            if tok is not None:
                ids = torch.tensor(tok.encode(t, context_length=77),
                                   device=self.device)
                v = vit.clip_text_forward(self.params, ids, self.text_heads)
            else:
                seed = int.from_bytes(
                    hashlib.sha256(t.encode()).digest()[:4], "little")
                v = torch.randn(
                    (self.feature_dim,),
                    generator=torch.Generator().manual_seed(seed)
                ).to(self.device)
            out.append(v / torch.linalg.vector_norm(v))
        return torch.stack(out)


@register("hash-proj")
@dataclasses.dataclass
class HashProjectionExtractor(BaseExtractor):
    """Deterministic, download-free extractor: multi-scale pooled colour
    statistics through a fixed random projection; host numpy, returned as
    CPU tensors."""

    feature_dim: int = 64
    patch_size: int = 8
    resolution: int = 256

    def __post_init__(self):
        rng = np.random.RandomState(0)
        self._proj = rng.randn(27, self.feature_dim).astype(np.float32)
        self._proj /= np.linalg.norm(self._proj, axis=0, keepdims=True)

    def __call__(self, image) -> torch.Tensor:
        img = np.asarray(image, np.float32)
        h, w = img.shape[:2]
        ph, pw = max(h // self.patch_size, 1), max(w // self.patch_size, 1)
        img = img[: ph * self.patch_size, : pw * self.patch_size]
        cells = img.reshape(ph, self.patch_size, pw, self.patch_size, 3)
        mean = cells.mean((1, 3))
        std = cells.std((1, 3))
        mx = cells.max((1, 3))
        stats = np.concatenate([mean, std, mx], -1)      # [ph, pw, 9]
        # Two pooled context scales.
        pool = stats.reshape(ph, pw, 9)
        ctx = pool.mean((0, 1), keepdims=True) * np.ones_like(pool)
        row = pool.mean(1, keepdims=True) * np.ones_like(pool)
        feats = np.concatenate([pool, row, ctx], -1) @ self._proj
        return torch.from_numpy(
            np.ascontiguousarray(feats.transpose(2, 0, 1), np.float32))

    def encode_text(self, texts) -> torch.Tensor:
        vecs = []
        for t in texts:
            seed = int.from_bytes(
                hashlib.sha256(t.encode()).digest()[:4], "little"
            )
            v = np.random.RandomState(seed).randn(self.feature_dim)
            vecs.append(v / np.linalg.norm(v))
        return torch.from_numpy(np.stack(vecs).astype(np.float32))

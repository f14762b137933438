"""Two-layer feature decoder: a shared hidden layer and one head per branch.

Counterpart of the JAX package's ``features/decoder.py``: decodes the
rendered 13-dim latent into each feature space (CLIP, DINOv2) the
rade-features model distills.  The decoder is an ``nn.Module`` of its own,
kept out of the per-Gaussian parameter dict, whose entries the refinement
and capacity code treat as [C, ...] rows.

Layout: ``nn.Linear`` keeps its weight as [out, in], the JAX package as
[in, out]; :func:`decoder_from_numpy` and :func:`decoder_to_numpy` transpose
once, in one place.

The bilinear resize is the JAX package's ``jax.image.resize(method=
"linear")``, which antialiases when it downsamples (the training path takes
a 1280x720 latent map to a 64x36 feature map).  It is built from the same
per-axis resampling matrices as JAX's ``scale_and_translate`` and applied
as two products, so its backward is two products too: no float atomics, as
``F.interpolate``'s CUDA backward would have.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from ..utils.device import resolve_device


class TwoLayerDecoder(nn.Module):
    """``relu(x @ W_h + b_h)`` shared, then one linear head per branch,
    the branches in sorted order (JAX ``branch_names``)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 feature_dims: Mapping[str, Tuple[int, ...]],
                 generator: Optional[torch.Generator] = None, device=None):
        """``feature_dims``: branch -> (C, H, W) of its ground truth; only C
        is used.  Weights are He-normal and biases uniform(-1, 1) /
        sqrt(fan_in), as the JAX package draws them (drawn from
        ``generator`` on its device, then moved to ``device``, the card by
        default): with zero latents the nonzero hidden bias is what lets
        gradient reach the latents through the ReLU."""
        super().__init__()
        dev = resolve_device(device)
        self.hidden = skip_init(nn.Linear, input_dim, hidden_dim, device=dev)
        self.branches = nn.ModuleDict({
            name: skip_init(nn.Linear, hidden_dim, shape[0], device=dev)
            for name, shape in sorted(feature_dims.items())})
        gen_dev = generator.device if generator is not None \
            else torch.device("cpu")
        with torch.no_grad():
            for layer in (self.hidden, *self.branches.values()):
                fan_in = layer.in_features
                w = torch.randn((fan_in, layer.out_features),
                                generator=generator, device=gen_dev)
                b = torch.rand((layer.out_features,), generator=generator,
                               device=gen_dev)
                layer.weight.copy_((w * math.sqrt(2.0 / fan_in)).T)
                layer.bias.copy_((2.0 * b - 1.0) / math.sqrt(fan_in))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Latents [..., C_in] -> {branch: [..., C_out]}: per-pixel maps and
        per-Gaussian rows alike."""
        h = torch.relu(self.hidden(x))
        return {name: head(h) for name, head in self.branches.items()}


def decode(decoder: TwoLayerDecoder,
           x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Decode latents [..., C_in] to {branch: [..., C_out]} (JAX
    ``decode(params, x)``)."""
    return decoder(x)


def decoder_from_numpy(arrays: Mapping[str, np.ndarray],
                       device=None) -> TwoLayerDecoder:
    """A decoder holding the JAX package's weights (``hidden_w`` [in,
    hidden], ``hidden_b``, ``branch_<name>_w`` [hidden, C], ``_b``)."""
    w = np.asarray(arrays["hidden_w"])
    dims = {k[len("branch_"):-2]: (np.asarray(v).shape[1],)
            for k, v in arrays.items()
            if k.startswith("branch_") and k.endswith("_w")}
    dec = TwoLayerDecoder(w.shape[0], w.shape[1], dims, device=device)
    load_numpy(dec, arrays)
    return dec


@torch.no_grad()
def load_numpy(decoder: TwoLayerDecoder,
               arrays: Mapping[str, np.ndarray]) -> None:
    """Copy the JAX package's weights into ``decoder``, in place (its
    tensors stay the ones an optimizer holds)."""
    for key, t in decoder_tensors(decoder).items():
        t.copy_(torch.tensor(torch_layout(key, arrays[key])))


def decoder_to_numpy(decoder: TwoLayerDecoder) -> Dict[str, np.ndarray]:
    """The decoder's weights under the JAX package's names and layout."""
    return {key: jax_layout(key, t.detach().cpu().numpy())
            for key, t in decoder_tensors(decoder).items()}


def decoder_tensors(decoder: TwoLayerDecoder) -> Dict[str, torch.Tensor]:
    """The decoder's parameters under the JAX package's names, in the
    order of ``decoder.parameters()``."""
    out = {"hidden_w": decoder.hidden.weight, "hidden_b": decoder.hidden.bias}
    for name, head in decoder.branches.items():
        out[f"branch_{name}_w"] = head.weight
        out[f"branch_{name}_b"] = head.bias
    return out


def torch_layout(key: str, x) -> np.ndarray:
    """A decoder array named ``key`` from JAX's layout to ``nn.Linear``'s
    (weights transposed)."""
    x = np.asarray(x, np.float32)
    return np.ascontiguousarray(x.T) if key.endswith("_w") else x


def jax_layout(key: str, x: np.ndarray) -> np.ndarray:
    """The inverse of :func:`torch_layout`."""
    return np.ascontiguousarray(x.T) if key.endswith("_w") else x


@functools.lru_cache(maxsize=32)
def _resample_matrix(n_in: int, n_out: int, device: torch.device,
                     antialias: bool = True):
    """[n_out, n_in] float32 weights of JAX's ``compute_weight_mat`` for
    the triangle kernel: half-pixel centres, the kernel widened by 1/scale
    when downsampling with ``antialias``, columns normalised, samples
    outside the input zeroed.  Computed once per shape and device, in
    float32 as JAX computes it; read-only.  XLA may fuse a multiply-add
    where numpy rounds twice, so a sample position near n can differ by
    half an ulp of n (a weight by 3e-5 at n = 512)."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, np.float32(1.0)) if antialias else np.float32(1.0)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0).astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(w.T), device=device)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    axes: Tuple[int, int] = (0, 1),
                    antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of ``x``'s two ``axes`` to ``size``: JAX's
    ``jax.image.resize(..., method="linear", antialias=antialias)`` (half-
    pixel centres; with ``antialias``, JAX's default, the kernel widens
    when it downsamples).  The default axes take [H, W, C] to (H', W').
    Each axis whose size changes is one product with its resampling
    matrix; an axis whose size is kept is left as it is."""
    for axis, n_out in zip(axes, size):
        axis %= x.dim()
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        m = _resample_matrix(n_in, n_out, x.device, antialias)
        if axis == x.dim() - 1:
            x = x @ m.T
            continue
        shape = list(x.shape)
        pre = math.prod(shape[:axis])
        x = torch.matmul(m, x.reshape(pre, n_in, -1)) if pre > 1 else \
            (m @ x.reshape(n_in, -1))
        shape[axis] = n_out
        x = x.reshape(shape)
    return x


def decode_rendered_features(
    decoder: TwoLayerDecoder,
    features_hw: torch.Tensor,
    feature_dims: Mapping[str, Tuple[int, ...]],
    main_name: str,
    resize_factor: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Resize the rendered latent map [H, W, L] to the main branch's
    (scaled) feature resolution, decode every branch, resize the other
    branches to their own size; returns [C, H, W] maps."""
    _, main_h, main_w = feature_dims[main_name]
    target = (int(main_h * resize_factor), int(main_w * resize_factor))
    decoded = decode(decoder, resize_bilinear(features_hw, target))
    out = {}
    for name, dims in feature_dims.items():
        m = decoded[name]
        if name != main_name:
            m = resize_bilinear(m, (dims[1], dims[2]))
        out[name] = m.permute(2, 0, 1)
    return out

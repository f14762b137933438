"""The ViT towers of DINOv2 and (Mask)CLIP, as functions of a parameter
dict.

Counterpart of the JAX package's ``features/vit.py``, with its parameter
names and layout (the converters' flat dict, ``x @ w + b``), so a
converted ``.npz`` (``scripts/convert_weights.py``) loads unchanged
through :func:`params_from_numpy`:

* **DINOv2**: patch embed, CLS token, learned positions interpolated
  bicubically to the input grid, pre-norm blocks with LayerScale and exact
  GELU, LayerNorm eps 1e-6; output the normalised patch tokens.
* **CLIP visual** with the **MaskCLIP head**: blocks with QuickGELU and
  LayerNorm eps 1e-5; the last block's attention is replaced by the
  per-token value path ``out_proj(v_proj(ln_1(x)))``, then ``ln_post`` and
  the projection map every patch token into the joint embedding.
* **CLIP text**: causal blocks, ``ln_final``, the features at the argmax
  (EOT) token, projected.

Attention is the plain ``softmax(q kᵀ / sqrt(d)) v`` in float32, as JAX
computes it: the products go to ``torch.matmul`` with TF32 off (the
package's ``__init__``).  The ``init_*`` functions give parameters of the
released shapes, drawn from a ``torch.Generator``: not JAX's values.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

Params = Dict[str, torch.Tensor]


def params_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> Params:
    """A converted ``.npz``'s arrays (or the JAX package's parameters as
    numpy) as tensors: floats on ``device`` (the card by default), the
    integer fields (block counts, heads, window) on the CPU, where they
    are read as Python ints."""
    dev = resolve_device(device)
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            out[k] = torch.tensor(a.astype(np.float32), device=dev)
        else:
            out[k] = torch.tensor(a)
    return out


def load_params(path, device=None) -> Params:
    """A converted ``.npz`` weights file through :func:`params_from_numpy`."""
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files}, device)


def layer_norm(x, scale, bias, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def attention(x, p, prefix, num_heads, causal=False):
    """Multi-head self-attention over tokens [..., T, D]; weights
    ``{prefix}.{wq,wk,wv,wo}`` [D, D] and ``{prefix}.{bq,bk,bv,bo}``."""
    *lead, t, d = x.shape
    hd = d // num_heads

    def heads(nm):
        y = x @ p[f"{prefix}.w{nm}"] + p[f"{prefix}.b{nm}"]
        return y.reshape(*lead, t, num_heads, hd).transpose(-3, -2)

    q, k, v = heads("q"), heads("k"), heads("v")
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~mask, float("-inf"))
    o = (torch.softmax(att, dim=-1) @ v).transpose(-3, -2)
    return o.reshape(*lead, t, d) @ p[f"{prefix}.wo"] + p[f"{prefix}.bo"]


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def patchify(image: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[H, W, 3] -> [h * w, P * P * 3] patches in the converters' (row,
    column, channel) order."""
    hh, ww, c = image.shape
    h, w = hh // patch_size, ww // patch_size
    x = image.reshape(h, patch_size, w, patch_size, c).permute(0, 2, 1, 3, 4)
    return x.reshape(h * w, -1)


# ------------------------------------------------------------------ DINOv2


def dinov2_block(x, p, i, num_heads):
    pre = f"blocks.{i}"
    h = layer_norm(x, p[f"{pre}.ln1.scale"], p[f"{pre}.ln1.bias"])
    h = attention(h, p, f"{pre}.attn", num_heads)
    x = x + p[f"{pre}.ls1"] * h                       # LayerScale gamma_1
    h = layer_norm(x, p[f"{pre}.ln2.scale"], p[f"{pre}.ln2.bias"])
    h = F.gelu(h @ p[f"{pre}.mlp.w1"] + p[f"{pre}.mlp.b1"])
    h = h @ p[f"{pre}.mlp.w2"] + p[f"{pre}.mlp.b2"]
    return x + p[f"{pre}.ls2"] * h                    # LayerScale gamma_2


def interpolate_pos_embed(pos: torch.Tensor,
                          grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize the [1 + g*g, D] learned position table to an (h, w) patch
    grid: bicubic with a = -0.75, half-pixel centres and clamped borders,
    which is ``F.interpolate(mode="bicubic", align_corners=False)`` (the
    released models' own call; the JAX package writes out its matrix)."""
    h, w = grid_hw
    cls_pos, patch_pos = pos[:1], pos[1:]
    g = int(round(math.sqrt(patch_pos.shape[0])))
    if (h, w) != (g, g):
        grid = patch_pos.reshape(g, g, -1).permute(2, 0, 1)[None]
        grid = F.interpolate(grid, size=(h, w), mode="bicubic",
                             align_corners=False)
        patch_pos = grid[0].permute(1, 2, 0).reshape(h * w, -1)
    return torch.cat([cls_pos, patch_pos], dim=0)


def dinov2_forward(params: Params, image: torch.Tensor, num_heads: int,
                   patch_size: int) -> torch.Tensor:
    """DINOv2 ``x_norm_patchtokens`` of an [H, W, 3] normalised image (H, W
    multiples of ``patch_size``): [h * w, D]."""
    h, w = image.shape[0] // patch_size, image.shape[1] // patch_size
    x = patchify(image, patch_size) @ params["patch_embed.w"] \
        + params["patch_embed.b"]
    x = torch.cat([params["cls_token"][None], x], dim=0)
    x = x + interpolate_pos_embed(params["pos_embed"], (h, w))
    for i in range(int(params["n_blocks"])):
        x = dinov2_block(x, params, i, num_heads)
    x = layer_norm(x, params["norm.scale"], params["norm.bias"])
    return x[1:]


def _normal(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=gen.device).mul_(
        scale).to(device)


def _init_block(p, pre, dim, hidden, gen, device):
    """One pre-norm block's parameters: unit LayerNorms, zero biases,
    normal(0, 1/sqrt(dim)) weights."""
    sc = 1.0 / math.sqrt(dim)
    for ln in ("ln1", "ln2"):
        p[f"{pre}.{ln}.scale"] = torch.ones(dim, device=device)
        p[f"{pre}.{ln}.bias"] = torch.zeros(dim, device=device)
    for nm in "qkvo":
        p[f"{pre}.attn.w{nm}"] = _normal(gen, (dim, dim), sc, device)
        p[f"{pre}.attn.b{nm}"] = torch.zeros(dim, device=device)
    p[f"{pre}.mlp.w1"] = _normal(gen, (dim, hidden), sc, device)
    p[f"{pre}.mlp.b1"] = torch.zeros(hidden, device=device)
    p[f"{pre}.mlp.w2"] = _normal(gen, (hidden, dim), sc, device)
    p[f"{pre}.mlp.b2"] = torch.zeros(dim, device=device)


def init_dinov2_params(generator: Optional[torch.Generator] = None,
                       dim=384, n_blocks=12, patch_size=14, mlp_ratio=4,
                       grid=37, device=None) -> Params:
    """Random parameters with the released shapes (dinov2_vits14: dim 384,
    12 blocks, 6 heads, 37x37 training grid), LayerScale 1e-5, drawn from
    ``generator`` (seed 0 on the CPU by default) onto ``device``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    p: Params = {"n_blocks": torch.tensor(n_blocks)}
    p["patch_embed.w"] = _normal(gen, (patch_size ** 2 * 3, dim),
                                 1.0 / math.sqrt(dim), dev)
    p["patch_embed.b"] = torch.zeros(dim, device=dev)
    p["cls_token"] = _normal(gen, (dim,), 0.02, dev)
    p["pos_embed"] = _normal(gen, (1 + grid * grid, dim), 0.02, dev)
    for i in range(n_blocks):
        _init_block(p, f"blocks.{i}", dim, dim * mlp_ratio, gen, dev)
        p[f"blocks.{i}.ls1"] = torch.full((dim,), 1e-5, device=dev)
        p[f"blocks.{i}.ls2"] = torch.full((dim,), 1e-5, device=dev)
    p["norm.scale"] = torch.ones(dim, device=dev)
    p["norm.bias"] = torch.zeros(dim, device=dev)
    return p


# ------------------------------------------------------------- CLIP visual


def clip_block(x, p, i, num_heads, tower="visual", causal=False):
    pre = f"{tower}.blocks.{i}"
    h = layer_norm(x, p[f"{pre}.ln1.scale"], p[f"{pre}.ln1.bias"], eps=1e-5)
    x = x + attention(h, p, f"{pre}.attn", num_heads, causal=causal)
    h = layer_norm(x, p[f"{pre}.ln2.scale"], p[f"{pre}.ln2.bias"], eps=1e-5)
    h = quick_gelu(h @ p[f"{pre}.mlp.w1"] + p[f"{pre}.mlp.b1"])
    return x + h @ p[f"{pre}.mlp.w2"] + p[f"{pre}.mlp.b2"]


def maskclip_forward(params: Params, image: torch.Tensor, num_heads: int,
                     patch_size: int) -> torch.Tensor:
    """Dense patch-level CLIP embeddings [h * w, E] of an [H, W, 3]
    normalised image: the visual tower through blocks [0, L-1), then the
    MaskCLIP head on the last block (the value path in place of attention,
    its MLP residual kept), ``ln_post`` and the projection; CLS dropped."""
    h, w = image.shape[0] // patch_size, image.shape[1] // patch_size
    x = patchify(image, patch_size) @ params["visual.patch_embed.w"]
    x = torch.cat([params["visual.class_embedding"][None], x], dim=0)
    x = x + interpolate_pos_embed(params["visual.pos_embed"], (h, w))
    x = layer_norm(x, params["visual.ln_pre.scale"],
                   params["visual.ln_pre.bias"], eps=1e-5)
    n_blocks = int(params["visual.n_blocks"])
    for i in range(n_blocks - 1):
        x = clip_block(x, params, i, num_heads)
    pre = f"visual.blocks.{n_blocks - 1}"
    hln = layer_norm(x, params[f"{pre}.ln1.scale"],
                     params[f"{pre}.ln1.bias"], eps=1e-5)
    v = hln @ params[f"{pre}.attn.wv"] + params[f"{pre}.attn.bv"]
    x = x + (v @ params[f"{pre}.attn.wo"] + params[f"{pre}.attn.bo"])
    hln = layer_norm(x, params[f"{pre}.ln2.scale"],
                     params[f"{pre}.ln2.bias"], eps=1e-5)
    hln = quick_gelu(hln @ params[f"{pre}.mlp.w1"] + params[f"{pre}.mlp.b1"])
    x = x + hln @ params[f"{pre}.mlp.w2"] + params[f"{pre}.mlp.b2"]
    x = layer_norm(x, params["visual.ln_post.scale"],
                   params["visual.ln_post.bias"], eps=1e-5)
    return (x @ params["visual.proj"])[1:]


def init_clip_visual_params(generator: Optional[torch.Generator] = None,
                            dim=1024, n_blocks=24, patch_size=14,
                            embed_dim=768, grid=24, device=None) -> Params:
    """Random parameters with ViT-L/14@336px shapes (dim 1024, 24 blocks,
    16 heads, 24x24 grid at 336 px, joint embedding 768)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    sc = 1.0 / math.sqrt(dim)
    p: Params = {"visual.n_blocks": torch.tensor(n_blocks)}
    p["visual.patch_embed.w"] = _normal(gen, (patch_size ** 2 * 3, dim), sc,
                                        dev)
    p["visual.class_embedding"] = _normal(gen, (dim,), 0.02, dev)
    p["visual.pos_embed"] = _normal(gen, (1 + grid * grid, dim), 0.02, dev)
    p["visual.ln_pre.scale"] = torch.ones(dim, device=dev)
    p["visual.ln_pre.bias"] = torch.zeros(dim, device=dev)
    for i in range(n_blocks):
        _init_block(p, f"visual.blocks.{i}", dim, dim * 4, gen, dev)
    p["visual.ln_post.scale"] = torch.ones(dim, device=dev)
    p["visual.ln_post.bias"] = torch.zeros(dim, device=dev)
    p["visual.proj"] = _normal(gen, (dim, embed_dim), sc, dev)
    return p


# --------------------------------------------------------------- CLIP text


def clip_text_forward(params: Params, tokens: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """CLIP ``encode_text``: [T] int tokens -> [E] embedding (not
    normalised), taken at the EOT position (the argmax id, as in CLIP)."""
    x = params["text.token_embedding"][tokens]
    x = x + params["text.pos_embed"][: tokens.shape[0]]
    for i in range(int(params["text.n_blocks"])):
        x = clip_block(x, params, i, num_heads, tower="text", causal=True)
    x = layer_norm(x, params["text.ln_final.scale"],
                   params["text.ln_final.bias"], eps=1e-5)
    return x[torch.argmax(tokens)] @ params["text.proj"]


def init_clip_text_params(generator: Optional[torch.Generator] = None,
                          dim=768, n_blocks=12, vocab=49408, context=77,
                          embed_dim=768, device=None) -> Params:
    """Random parameters with ViT-L/14 text-tower shapes."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(1)
    p: Params = {"text.n_blocks": torch.tensor(n_blocks)}
    p["text.token_embedding"] = _normal(gen, (vocab, dim), 0.02, dev)
    p["text.pos_embed"] = _normal(gen, (context, dim), 0.01, dev)
    for i in range(n_blocks):
        _init_block(p, f"text.blocks.{i}", dim, dim * 4, gen, dev)
    p["text.ln_final.scale"] = torch.ones(dim, device=dev)
    p["text.ln_final.bias"] = torch.zeros(dim, device=dev)
    p["text.proj"] = _normal(gen, (dim, embed_dim), 1.0 / math.sqrt(dim),
                             dev)
    return p

"""Plain reference of the two feature towers that the feature datamanager
runs over every training image: MaskCLIP on CLIP ViT-L/14@336px and DINOv2
ViT-S/14, with their input preparation and the datamanager's final resize.

Plain PyTorch, float32 with TF32 off, no kernel, no cache and no batching
across images; it imports nothing of the program.  It is written from the
layer equations of

* CLIP's visual tower (Radford et al., arXiv:2103.00020; openai/CLIP
  ``clip/model.py::VisionTransformer``, ``_MODELS["ViT-L/14@336px"]``):
  14x14 patches mapped linearly to the width with no bias, the class
  embedding, learned positions, ``ln_pre``, pre-LayerNorm residual blocks
  (eps 1e-5) ``x + attn(ln_1(x))``, ``x + MLP(ln_2(x))`` with the MLP
  width -> 4 width -> width through QuickGELU ``x * sigmoid(1.702 x)``,
  ``ln_post`` and the projection to the joint embedding;
* the MaskCLIP head (Zhou et al., arXiv:2112.01071): the last block's
  attention replaced by the value path ``out_proj(v_proj(ln_1(x)))``, its
  MLP residual kept, then ``ln_post`` and the projection on every token;
  the class token dropped;
* DINOv2 (Oquab et al., arXiv:2304.07193; facebookresearch/dinov2
  ``hubconf.py::dinov2_vits14``): 14x14 patches mapped linearly with a
  bias, the class token, learned positions, pre-LayerNorm blocks (eps
  1e-6) with LayerScale, ``x + ls1 * attn(norm1(x))``, ``x + ls2 *
  MLP(norm2(x))``, the MLP through exact GELU, the final norm; the output
  is the normalised patch tokens (``x_norm_patchtokens``);

on weights in the converters' layout (``scripts/convert_weights.py``:
``x @ w + b``, a patch flattened in (row, column, channel) order).

Attention is computed one head at a time, with ``q`` scaled before its
product with ``k``; the learned positions are resized by explicit
resampling matrices.  The sums therefore run in another order than a
batched implementation's.

Departures from the published description, each as the program has it:

* the image is prepared in float32 in two stages, as Feature Splatting's
  (arXiv:2404.01223) extraction chain does: its longest edge resized to
  the tower's ``resolution`` (1024 for CLIP, 800 for DINOv2) with an
  antialiased bilinear resize, then a plain bilinear resize down to
  multiples of the patch; CLIP's own preprocessing (a bicubic resize of
  the shortest edge to 336 and a centre crop) and DINOv2's are not used;
* the normalisation is the program's: ImageNet's mean and deviation for
  CLIP (CLIP's published ones are (0.4815, 0.4578, 0.4082) and (0.2686,
  0.2613, 0.2758)), and 0.5 and 0.5 for DINOv2 (published: ImageNet's);
* the learned positions are interpolated to the patch grid bicubically
  (a = -0.75, half-pixel centres, clamped borders) at the grid's size;
  DINOv2's hub code asks for a scale factor with an offset of 0.1, which
  rounds to the same grid;
* the maps are brought down to a long edge of ``final_resolution`` (64)
  with an antialiased bilinear resize, the feature datamanager's cache
  format; a map whose long edge is already within it is left as it is.

``Precision(tf32=True)`` rounds every operand of a product to TF32 (10
explicit mantissa bits, nearest even) and accumulates in float32, as the
tensor cores do: a control one precision below the float32 that the
configuration states, which rounds the same on the CPU and on the card.
The faults of the benchmark's limits (the MaskCLIP block run as ordinary
attention, the positions resized bilinearly, DINOv2's LayerScale left
out, the maps left at their grids' size) are arguments of the forward
passes and of :func:`tower_map`.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

CLIP_LN_EPS = 1e-5
DINO_LN_EPS = 1e-6

Params = Dict[str, torch.Tensor]


class ClipSpec(NamedTuple):
    """CLIP ViT-L/14@336px's sizes (``clip/model.py::build_model`` on the
    released state dict): the visual tower, its 24x24 position table at
    336 px, the joint embedding and the text tower."""

    width: int = 1024
    layers: int = 24
    heads: int = 16
    patch: int = 14
    grid: int = 24
    embed: int = 768
    text_width: int = 768
    text_layers: int = 12
    vocab: int = 49408
    context: int = 77


class DinoSpec(NamedTuple):
    """dinov2_vits14's sizes: 384 wide, 12 blocks of 6 heads, MLP ratio 4,
    a 37x37 position table (518 px at patch 14)."""

    width: int = 384
    layers: int = 12
    heads: int = 6
    patch: int = 14
    grid: int = 37
    mlp_ratio: int = 4


# ---------------------------------------------------------------- precision
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    r = (i + 0xFFF + lsb) & ~0x1FFF
    r = torch.where(torch.isfinite(x), r, i)
    r = torch.where(r > 0x7FFFFFFF, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32).view(x.shape)


class Precision:
    """The reference's products at one precision (TF32 off in the
    library either way)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)


# ----------------------------------------------------------------- weights
def _draws(generator: Optional[torch.Generator], device):
    """Draw helpers on one generator: ``w`` a linear map's weight with
    variance 1 / fan_in, ``b`` a bias at 0.02, ``ln`` a LayerNorm with
    scale 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1), ``n`` a table at a given
    deviation."""

    def n(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def w(fan_in, fan_out):
        return n((fan_in, fan_out), 1.0 / math.sqrt(fan_in))

    def b(d):
        return n((d,), 0.02)

    def ln(p, pre, d):
        p[f"{pre}.scale"] = 1.0 + n((d,), 0.1)
        p[f"{pre}.bias"] = n((d,), 0.1)

    return n, w, b, ln


def _block(p: Params, pre: str, dim: int, hidden: int, draws) -> None:
    n, w, b, ln = draws
    ln(p, f"{pre}.ln1", dim)
    for nm in "qkvo":
        p[f"{pre}.attn.w{nm}"] = w(dim, dim)
        p[f"{pre}.attn.b{nm}"] = b(dim)
    ln(p, f"{pre}.ln2", dim)
    p[f"{pre}.mlp.w1"], p[f"{pre}.mlp.b1"] = w(dim, hidden), b(hidden)
    p[f"{pre}.mlp.w2"], p[f"{pre}.mlp.b2"] = w(hidden, dim), b(dim)


def init_clip(spec: ClipSpec, generator: Optional[torch.Generator],
              device) -> Params:
    """Seeded weights of the visual and text towers under the converter's
    ``visual.*`` and ``text.*`` names: linear weights with variance
    1 / fan_in, biases at 0.02, LayerNorms near unit, the class embedding
    and the positions at width ** -0.5 (CLIP's own initialisation), the
    token table at 0.02 and the text positions at 0.01."""
    draws = _draws(generator, device)
    n, w, b, ln = draws
    d, pp = spec.width, spec.patch * spec.patch * 3
    p: Params = {"visual.n_blocks": torch.tensor(spec.layers),
                 "visual.patch_embed.w": w(pp, d),
                 "visual.class_embedding": n((d,), d ** -0.5),
                 "visual.pos_embed": n((1 + spec.grid ** 2, d), d ** -0.5)}
    ln(p, "visual.ln_pre", d)
    for i in range(spec.layers):
        _block(p, f"visual.blocks.{i}", d, 4 * d, draws)
    ln(p, "visual.ln_post", d)
    p["visual.proj"] = w(d, spec.embed)
    t = spec.text_width
    p["text.n_blocks"] = torch.tensor(spec.text_layers)
    p["text.token_embedding"] = n((spec.vocab, t), 0.02)
    p["text.pos_embed"] = n((spec.context, t), 0.01)
    for i in range(spec.text_layers):
        _block(p, f"text.blocks.{i}", t, 4 * t, draws)
    ln(p, "text.ln_final", t)
    p["text.proj"] = w(t, spec.embed)
    return p


def init_dinov2(spec: DinoSpec, generator: Optional[torch.Generator],
                device, layer_scale: Tuple[float, float] = (0.25, 0.75)
                ) -> Params:
    """Seeded weights under the converter's DINOv2 names: as
    :func:`init_clip`'s, the patch embedding with a bias, the class token
    and the positions at 0.02, and each LayerScale drawn per channel
    uniform in ``layer_scale`` (the released model's init of 1e-5 would
    hide every block below rounding)."""
    draws = _draws(generator, device)
    n, w, b, ln = draws
    d, pp = spec.width, spec.patch * spec.patch * 3
    lo, hi = layer_scale
    p: Params = {"n_blocks": torch.tensor(spec.layers),
                 "patch_embed.w": w(pp, d), "patch_embed.b": b(d),
                 "cls_token": n((d,), 0.02),
                 "pos_embed": n((1 + spec.grid ** 2, d), 0.02)}
    for i in range(spec.layers):
        pre = f"blocks.{i}"
        _block(p, pre, d, spec.mlp_ratio * d, draws)
        for ls in ("ls1", "ls2"):
            u = torch.rand((d,), generator=generator, device=device)
            p[f"{pre}.{ls}"] = lo + (hi - lo) * u
    ln(p, "norm", d)
    return p


# ---------------------------------------------------------- image and maps
def _resize(x: torch.Tensor, size: Tuple[int, int],
            antialias: bool) -> torch.Tensor:
    """[H, W, C] bilinearly resized to ``size`` (half-pixel centres)."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=size, mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y[0].permute(1, 2, 0)


def prepare(image01: torch.Tensor, resolution: int, patch: int,
            mean: Sequence[float], std: Sequence[float]
            ) -> Tuple[torch.Tensor, int, int]:
    """An [H, W, 3] image in [0, 1] -> (the normalised [th, tw, 3] input,
    grid rows, grid columns): the longest edge to ``resolution``
    (antialiased), then down to multiples of ``patch`` (not
    antialiased)."""
    h, w = image01.shape[:2]
    scale = resolution / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    th, tw = max(nh // patch, 1) * patch, max(nw // patch, 1) * patch
    x = _resize(image01, (nh, nw), antialias=True)
    if (nh, nw) != (th, tw):
        x = _resize(x, (th, tw), antialias=False)
    dev = image01.device
    x = (x - torch.tensor(mean, device=dev)) / torch.tensor(std, device=dev)
    return x, th // patch, tw // patch


def final_resize(feat: torch.Tensor, max_edge: int) -> torch.Tensor:
    """A [C, h, w] map with its long edge brought down to ``max_edge``
    (antialiased bilinear); a map already within it is returned as it
    is."""
    _, h, w = feat.shape
    scale = max_edge / max(h, w)
    if scale >= 1.0:
        return feat
    size = (max(int(h * scale), 1), max(int(w * scale), 1))
    return F.interpolate(feat[None], size=size, mode="bilinear",
                         align_corners=False, antialias=True)[0]


def _cubic(t: float, a: float = -0.75) -> float:
    t = abs(t)
    if t <= 1.0:
        return ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    if t < 2.0:
        return ((a * t - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a
    return 0.0


def resample_matrix(n_in: int, n_out: int, kind: str) -> torch.Tensor:
    """[n_out, n_in] weights of a resize with half-pixel centres:
    ``bicubic`` (a = -0.75, taps clamped to the border) or ``bilinear``
    (the source clamped at 0, the last tap at the border)."""
    m = torch.zeros((n_out, n_in), dtype=torch.float64)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        if kind == "bicubic":
            i0 = math.floor(src)
            t = src - i0
            for k in range(-1, 3):
                m[o, min(max(i0 + k, 0), n_in - 1)] += _cubic(t - k)
        elif kind == "bilinear":
            src = max(src, 0.0)
            i0 = int(src)
            t = src - i0
            m[o, i0] += 1.0 - t
            m[o, min(i0 + 1, n_in - 1)] += t
        else:
            raise ValueError(f"unknown resize {kind!r}")
    return m.to(torch.float32)


def positions(table: torch.Tensor, rows: int, cols: int,
              kind: str = "bicubic") -> torch.Tensor:
    """A [1 + g * g, D] position table on a (rows, cols) patch grid: the
    class position first, the grid resized by ``kind``."""
    g = int(round(math.sqrt(table.shape[0] - 1)))
    grid = table[1:].reshape(g, g, -1)
    if (rows, cols) != (g, g):
        dev = table.device
        mh = resample_matrix(g, rows, kind).to(dev)
        mw = resample_matrix(g, cols, kind).to(dev)
        grid = torch.einsum("ia,abd->ibd", mh, grid)
        grid = torch.einsum("jb,ibd->ijd", mw, grid)
    return torch.cat([table[:1], grid.reshape(rows * cols, -1)], dim=0)


def patches(image: torch.Tensor, patch: int) -> torch.Tensor:
    """[H, W, 3] -> [h * w, P * P * 3], each patch in (row, column,
    channel) order."""
    hh, ww, c = image.shape
    h, w = hh // patch, ww // patch
    x = image.reshape(h, patch, w, patch, c).permute(0, 2, 1, 3, 4)
    return x.reshape(h * w, patch * patch * c)


# ------------------------------------------------------------------ towers
def layer_norm(x, p: Params, pre: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[f"{pre}.scale"],
                        p[f"{pre}.bias"], eps)


def linear(x, p: Params, w: str, b: str, prec: Precision):
    return prec.mm(x, p[w]) + p[b]


def attention(x, p: Params, pre: str, heads: int, prec: Precision):
    """Self-attention over [T, D] tokens, one head at a time."""
    d = x.shape[-1]
    hd = d // heads
    outs = []
    for h in range(heads):
        cols = slice(h * hd, (h + 1) * hd)

        def proj(nm):
            return prec.mm(x, p[f"{pre}.w{nm}"][:, cols]) \
                + p[f"{pre}.b{nm}"][cols]

        q = proj("q") * (1.0 / math.sqrt(hd))
        logits = prec.mm(q, proj("k").T)
        outs.append(prec.mm(torch.softmax(logits, dim=-1), proj("v")))
    return linear(torch.cat(outs, dim=-1), p, f"{pre}.wo", f"{pre}.bo",
                  prec)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _mlp(x, p: Params, pre: str, act, prec: Precision):
    h = act(linear(x, p, f"{pre}.mlp.w1", f"{pre}.mlp.b1", prec))
    return linear(h, p, f"{pre}.mlp.w2", f"{pre}.mlp.b2", prec)


def maskclip_forward(p: Params, image: torch.Tensor, rows: int, cols: int,
                     heads: int, patch: int, prec: Precision,
                     maskclip_head: bool = True,
                     pos_kind: str = "bicubic") -> torch.Tensor:
    """Dense CLIP embeddings [rows * cols, E] of a normalised [H, W, 3]
    image: every block but the last as CLIP runs it, the last with the
    value path in place of attention (with ``maskclip_head`` False: as
    an ordinary block, the fault), ``ln_post`` and the projection."""
    x = prec.mm(patches(image, patch), p["visual.patch_embed.w"])
    x = torch.cat([p["visual.class_embedding"][None], x], dim=0)
    x = x + positions(p["visual.pos_embed"], rows, cols, pos_kind)
    x = layer_norm(x, p, "visual.ln_pre", CLIP_LN_EPS)
    depth = int(p["visual.n_blocks"])
    for i in range(depth):
        pre = f"visual.blocks.{i}"
        h = layer_norm(x, p, f"{pre}.ln1", CLIP_LN_EPS)
        if i == depth - 1 and maskclip_head:
            v = linear(h, p, f"{pre}.attn.wv", f"{pre}.attn.bv", prec)
            x = x + linear(v, p, f"{pre}.attn.wo", f"{pre}.attn.bo", prec)
        else:
            x = x + attention(h, p, f"{pre}.attn", heads, prec)
        x = x + _mlp(layer_norm(x, p, f"{pre}.ln2", CLIP_LN_EPS), p, pre,
                     quick_gelu, prec)
    x = layer_norm(x[1:], p, "visual.ln_post", CLIP_LN_EPS)
    return prec.mm(x, p["visual.proj"])


def dinov2_forward(p: Params, image: torch.Tensor, rows: int, cols: int,
                   heads: int, patch: int, prec: Precision,
                   layer_scale: bool = True,
                   pos_kind: str = "bicubic") -> torch.Tensor:
    """DINOv2's normalised patch tokens [rows * cols, D] of a normalised
    [H, W, 3] image (with ``layer_scale`` False: the blocks' LayerScale
    left out, the fault)."""
    x = linear(patches(image, patch), p, "patch_embed.w", "patch_embed.b",
               prec)
    x = torch.cat([p["cls_token"][None], x], dim=0)
    x = x + positions(p["pos_embed"], rows, cols, pos_kind)
    for i in range(int(p["n_blocks"])):
        pre = f"blocks.{i}"
        ls1 = p[f"{pre}.ls1"] if layer_scale else 1.0
        ls2 = p[f"{pre}.ls2"] if layer_scale else 1.0
        h = layer_norm(x, p, f"{pre}.ln1", DINO_LN_EPS)
        x = x + ls1 * attention(h, p, f"{pre}.attn", heads, prec)
        h = layer_norm(x, p, f"{pre}.ln2", DINO_LN_EPS)
        x = x + ls2 * _mlp(h, p, pre, F.gelu, prec)
    return layer_norm(x, p, "norm", DINO_LN_EPS)[1:]


class Tower(NamedTuple):
    """One tower's settings as the configuration states them."""

    resolution: int
    patch: int
    heads: int
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]


def tower_map(kind: str, p: Params, image_uint8: torch.Tensor, t: Tower,
              final_resolution: int, prec: Precision,
              fault: Optional[str] = None) -> torch.Tensor:
    """One tower's final [C, h, w] map of a uint8 [H, W, 3] frame: the
    frame over 255 in float32, prepared, through the tower (``kind``
    ``clip`` or ``dinov2``), in channel-major order, brought down to
    ``final_resolution``.  ``fault``: ``attention_head`` (CLIP's last
    block as ordinary attention), ``bilinear_positions``,
    ``no_layer_scale`` (DINOv2) or ``no_final_resize``."""
    img, rows, cols = prepare(image_uint8.to(torch.float32) / 255.0,
                              t.resolution, t.patch, t.mean, t.std)
    pos = "bilinear" if fault == "bilinear_positions" else "bicubic"
    if kind == "clip":
        f = maskclip_forward(p, img, rows, cols, t.heads, t.patch, prec,
                             maskclip_head=fault != "attention_head",
                             pos_kind=pos)
    elif kind == "dinov2":
        f = dinov2_forward(p, img, rows, cols, t.heads, t.patch, prec,
                           layer_scale=fault != "no_layer_scale",
                           pos_kind=pos)
    else:
        raise ValueError(f"unknown tower {kind!r}")
    f = f.reshape(rows, cols, -1).permute(2, 0, 1).contiguous()
    if fault == "no_final_resize":
        return f
    return final_resize(f, final_resolution)

"""Plain reference of SAM's automatic mask generation: the ViT image
encoder, the prompt encoder, the two-way mask decoder and the automatic
masks' filter with greedy mask NMS.

Plain PyTorch, float32, no kernel, no cache and no batching across images;
it imports nothing of the program.  It is written from the layer equations
of Kirillov et al., "Segment Anything" (arXiv:2304.02643) as
``segment_anything`` builds them (``build_sam.py``, ``modeling/``,
``automatic_mask_generator.py``), on weights in the layout of
``scripts/convert_sam.py`` (``x @ w + b``; convolutions HWIO):

* patch embedding: 16x16 patches of the padded 1024x1024 image, a linear
  map to the width, plus the learned [64, 64, width] positions;
* pre-LayerNorm blocks (eps 1e-6): ``x + attn(LN(x))``, ``x + MLP(LN(x))``,
  the MLP width -> 4 width -> width with exact GELU; attention with a qkv
  bias, heads of width / heads, the logits ``q k / sqrt(d)`` plus the
  decomposed relative positions ``q . R_h[i - i'] + q . R_w[j - j']``
  (unscaled q); windowed blocks pad the 64x64 map to a multiple of the
  window and attend within each window, global blocks over all 4,096
  tokens, one head at a time;
* neck: 1x1 convolution to 256, channel LayerNorm, 3x3 convolution,
  channel LayerNorm (eps 1e-6);
* prompts: random-Fourier positions of the pixel centres, the foreground
  point's embedding, a padding point (``not_a_point``) when no box is
  given, the no-mask dense embedding;
* the two-way transformer (depth 2, 8 heads, MLP 2048 with ReLU, cross
  attention at half width, LayerNorms at ``nn.LayerNorm``'s eps 1e-5),
  the final token-to-image attention, the
  upscaling (two 2x2 stride-2 transposed convolutions with a channel
  LayerNorm and GELU), the hypernetwork MLPs and the IoU head;
* the automatic masks: a grid of points, three masks each, kept where the
  predicted IoU and the stability score reach their thresholds, upscaled,
  greedy NMS by predicted IoU.

Departures from SAM's code, each as the program has it:

* NMS is greedy on the masks' IoU; SAM runs box NMS on the masks' boxes;
* the stability score is taken on the 256x256 logits, before upscaling;
  SAM takes it on the upscaled logits;
* masks below ``min_area`` pixels are dropped before NMS (SAM's
  ``min_mask_region_area`` defaults to 0 and, when set, cleans holes);
* a mask passes the IoU threshold at equality (SAM: strictly above);
* the image is resized in float32 (SAM's ``ResizeLongestSide`` rounds it
  to uint8 through PIL);
* every resize is ``F.interpolate``'s antialiased bilinear, whose edge
  taps are renormalised (SAM's mask upscaling is plain bilinear, which
  clamps the sample position at the edges: up to 1e-5 of the largest
  logit apart when enlarging, and it does not antialias when shrinking);
* the grid is ``(i + 0.5) / n`` of each side (SAM: ``linspace(1 / 2n, 1 -
  1 / 2n, n)``, the same points but for rounding).

``Precision(tf32=True)`` rounds every operand of a product or convolution
to TF32 (10 explicit mantissa bits, nearest even) and accumulates in
float32, as the tensor cores do: a control one precision below the
float32 that SAM's configuration states, which rounds the same on the CPU
and on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

IMG = 1024
GRID = 64
PATCH = 16
PROMPT = 256
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
LN_EPS = 1e-6
DECODER_LN_EPS = 1e-5

Params = Dict[str, torch.Tensor]


class Spec(NamedTuple):
    """An image encoder's sizes (``build_sam.py``); the decoder's are
    fixed at 256 wide, depth 2, 8 heads, MLP 2048, 4 mask tokens."""

    dim: int
    depth: int
    heads: int
    global_blocks: Sequence[int]
    window: int = 14


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

    def linear(self, x, p: Params, pre: str) -> torch.Tensor:
        return self.mm(x, p[f"{pre}.w"]) + p[f"{pre}.b"]


def layer_norm(x, scale, bias, eps=LN_EPS):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


# ----------------------------------------------------------------- weights
def init_params(spec: Spec, generator: Optional[torch.Generator],
                device) -> Params:
    """Seeded weights in the converter's layout: linear weights normal
    with variance 1 / fan_in, zero biases, unit LayerNorms, positions
    and relative-position tables at 0.02 (the tables 2 * window - 1 long,
    2 * 64 - 1 in the global blocks), the IoU head's last layer at 0.01
    with its bias at 0.92, so that predictions clear 0.88.  On the
    ``meta`` device it holds shapes only."""
    dim = spec.dim

    def w(*shape, fan_in=None):
        fan = fan_in or shape[0]
        t = torch.randn(shape, generator=generator, device=device)
        return t / math.sqrt(fan)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def ln(pre, d):
        p[f"{pre}.scale"], p[f"{pre}.bias"] = ones(d), zeros(d)

    p = {"enc.patch_embed.w": w(PATCH * PATCH * 3, dim),
         "enc.patch_embed.b": zeros(dim),
         "enc.pos_embed": 0.02 * w(GRID, GRID, dim, fan_in=1),
         "enc.n_blocks": torch.tensor(spec.depth),
         "enc.window": torch.tensor(spec.window),
         "enc.num_heads": torch.tensor(spec.heads),
         "enc.global_blocks": torch.tensor(list(spec.global_blocks))}
    hd = dim // spec.heads
    for i in range(spec.depth):
        pre = f"enc.blocks.{i}"
        ln(f"{pre}.ln1", dim)
        ln(f"{pre}.ln2", dim)
        rel = 2 * (GRID if i in spec.global_blocks else spec.window) - 1
        p.update({f"{pre}.attn.qkv.w": w(dim, 3 * dim),
                  f"{pre}.attn.qkv.b": zeros(3 * dim),
                  f"{pre}.attn.proj.w": w(dim, dim),
                  f"{pre}.attn.proj.b": zeros(dim),
                  f"{pre}.attn.rel_pos_h": 0.02 * w(rel, hd, fan_in=1),
                  f"{pre}.attn.rel_pos_w": 0.02 * w(rel, hd, fan_in=1),
                  f"{pre}.mlp.w1": w(dim, 4 * dim),
                  f"{pre}.mlp.b1": zeros(4 * dim),
                  f"{pre}.mlp.w2": w(4 * dim, dim),
                  f"{pre}.mlp.b2": zeros(dim)})
    p["enc.neck.conv1.w"] = w(dim, PROMPT)
    ln("enc.neck.ln1", PROMPT)
    p["enc.neck.conv2.w"] = w(3, 3, PROMPT, PROMPT, fan_in=9 * PROMPT)
    ln("enc.neck.ln2", PROMPT)
    p["prompt.pe_gauss"] = w(2, PROMPT // 2, fan_in=1)
    for i in range(4):
        p[f"prompt.point_embed.{i}"] = w(PROMPT, fan_in=1)
    p["prompt.not_a_point"] = w(PROMPT, fan_in=1)
    p["prompt.no_mask"] = w(PROMPT, fan_in=1)
    p.update({"dec.iou_token": w(PROMPT, fan_in=1),
              "dec.mask_tokens": w(4, PROMPT, fan_in=1),
              "dec.n_layers": torch.tensor(2),
              "dec.num_heads": torch.tensor(8)})

    def attn(pre, inner):
        for nm in "qkv":
            p[f"{pre}.{nm}.w"], p[f"{pre}.{nm}.b"] = w(PROMPT, inner), \
                zeros(inner)
        p[f"{pre}.out.w"], p[f"{pre}.out.b"] = w(inner, PROMPT), zeros(PROMPT)

    for i in range(2):
        pre = f"dec.layers.{i}"
        attn(f"{pre}.self_attn", PROMPT)
        attn(f"{pre}.cross_t2i", PROMPT // 2)
        attn(f"{pre}.cross_i2t", PROMPT // 2)
        for j in (1, 2, 3, 4):
            ln(f"{pre}.ln{j}", PROMPT)
        p.update({f"{pre}.mlp.w1": w(PROMPT, 2048),
                  f"{pre}.mlp.b1": zeros(2048),
                  f"{pre}.mlp.w2": w(2048, PROMPT),
                  f"{pre}.mlp.b2": zeros(PROMPT)})
    attn("dec.final_attn", PROMPT // 2)
    ln("dec.ln_final", PROMPT)
    p.update({"dec.up1.w": w(2, 2, 64, PROMPT, fan_in=PROMPT),
              "dec.up1.b": zeros(64),
              "dec.up2.w": w(2, 2, 32, 64, fan_in=64),
              "dec.up2.b": zeros(32)})
    ln("dec.up_ln", 64)
    for j in range(4):
        for li, (a, b) in enumerate(((PROMPT, PROMPT), (PROMPT, PROMPT),
                                     (PROMPT, 32))):
            p[f"dec.hyper.{j}.w{li}"] = w(a, b)
            p[f"dec.hyper.{j}.b{li}"] = zeros(b)
    for li, (a, b) in enumerate(((PROMPT, PROMPT), (PROMPT, PROMPT),
                                 (PROMPT, 4))):
        p[f"dec.iou_head.w{li}"], p[f"dec.iou_head.b{li}"] = w(a, b), \
            zeros(b)
    p["dec.iou_head.w2"] = p["dec.iou_head.w2"] * 0.01
    p["dec.iou_head.b2"] = torch.full((4,), 0.92, device=device)
    return p


def parameter_count(p: Params) -> int:
    return sum(t.numel() for t in p.values() if t.is_floating_point())


# ------------------------------------------------------------ image encoder
def preprocess(image: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] pixels in 0..255 -> the [1024, 1024, 3] normalised image,
    longest side 1024, padded at the bottom and right with zeros."""
    h, w = image.shape[:2]
    scale = IMG / max(h, w)
    th, tw = int(round(h * scale)), int(round(w * scale))
    x = F.interpolate(image.permute(2, 0, 1)[None].float(), size=(th, tw),
                      mode="bilinear", align_corners=False,
                      antialias=True)[0].permute(1, 2, 0)
    x = (x - torch.tensor(MEAN, device=x.device)) \
        / torch.tensor(STD, device=x.device)
    out = torch.zeros((IMG, IMG, 3), device=x.device)
    out[:th, :tw] = x
    return out


def rel_table(n: int, table: torch.Tensor) -> torch.Tensor:
    """[n, n, d]: ``table[i - i' + n - 1]`` for query i and key i'."""
    if table.shape[0] != 2 * n - 1:
        raise ValueError(f"a relative-position table of {table.shape[0]} "
                         f"rows for {n} positions")
    i = torch.arange(n, device=table.device)
    return table[(i[:, None] - i[None, :]) + n - 1]


def attend(q, k, v, rh, rw, n, prec: Precision):
    """One head's attention over an n x n token map: q, k, v [n*n, d],
    logits ``q k / sqrt(d)`` plus the decomposed relative positions."""
    d = q.shape[-1]
    logits = prec.mm(q * d ** -0.5, k.T)             # [n*n, n*n]
    qm = prec.r(q).reshape(n, n, d)
    bias_h = torch.einsum("hwd,hkd->hwk", qm, prec.r(rh))   # key row
    bias_w = torch.einsum("hwd,wkd->hwk", qm, prec.r(rw))   # key column
    logits = logits.reshape(n, n, n, n) + bias_h[:, :, :, None] \
        + bias_w[:, :, None, :]
    att = torch.softmax(logits.reshape(n * n, n * n), dim=-1)
    return prec.mm(att, v)


def attention_map(x, p: Params, pre: str, heads: int, prec: Precision,
                  rel_rows: Optional[int] = None):
    """Self-attention over an [n, n, C] map, head by head.  ``rel_rows``
    takes that many middle rows of the relative-position tables (a
    global block's tables in a window, for the fault of
    :func:`encode`)."""
    n, _, c = x.shape
    hd = c // heads
    qkv = prec.linear(x.reshape(n * n, c), p, f"{pre}.qkv")   # [n*n, 3C]
    tables = []
    for nm in ("rel_pos_h", "rel_pos_w"):
        t = p[f"{pre}.{nm}"]
        if rel_rows is not None:
            mid = t.shape[0] // 2
            t = t[mid - rel_rows // 2: mid + rel_rows // 2 + 1]
        tables.append(rel_table(n, t))
    out = []
    for h in range(heads):
        q, k, v = (qkv[:, j * c + h * hd: j * c + (h + 1) * hd]
                   for j in range(3))
        out.append(attend(q, k, v, tables[0], tables[1], n, prec))
    o = torch.cat(out, dim=1)
    return prec.linear(o, p, f"{pre}.proj").reshape(n, n, c)


def encoder_block(x, p: Params, i: int, heads: int, window: int,
                  prec: Precision, rel_rows: Optional[int] = None):
    """Block i on the [64, 64, C] map; ``window`` 0 attends globally."""
    pre = f"enc.blocks.{i}"
    h0, w0, c = x.shape
    y = layer_norm(x, p[f"{pre}.ln1.scale"], p[f"{pre}.ln1.bias"])
    if window:
        hp = h0 + (-h0) % window
        wp = w0 + (-w0) % window
        pad = torch.zeros((hp, wp, c), device=x.device)
        pad[:h0, :w0] = y
        out = torch.zeros_like(pad)
        for r in range(0, hp, window):
            for s in range(0, wp, window):
                out[r:r + window, s:s + window] = attention_map(
                    pad[r:r + window, s:s + window], p, f"{pre}.attn",
                    heads, prec, rel_rows)
        y = out[:h0, :w0]
    else:
        y = attention_map(y, p, f"{pre}.attn", heads, prec)
    x = x + y
    y = layer_norm(x, p[f"{pre}.ln2.scale"], p[f"{pre}.ln2.bias"])
    y = F.gelu(prec.mm(y, p[f"{pre}.mlp.w1"]) + p[f"{pre}.mlp.b1"])
    return x + prec.mm(y, p[f"{pre}.mlp.w2"]) + p[f"{pre}.mlp.b2"]


def channel_norm(x, p: Params, pre: str):
    """LayerNorm2d over the channels of a [C, H, W] map (eps 1e-6)."""
    u = x.mean(0, keepdim=True)
    s = ((x - u) ** 2).mean(0, keepdim=True)
    x = (x - u) / torch.sqrt(s + LN_EPS)
    return p[f"{pre}.scale"][:, None, None] * x \
        + p[f"{pre}.bias"][:, None, None]


def encode(p: Params, image: torch.Tensor, prec: Precision,
           windowed: Sequence[int] = ()) -> torch.Tensor:
    """[1024, 1024, 3] normalised image -> [256, 64, 64] embedding.
    Blocks listed in ``windowed`` attend in windows even where the
    weights make them global (a fault for the benchmark's check)."""
    patches = image.reshape(GRID, PATCH, GRID, PATCH, 3).permute(
        0, 2, 1, 3, 4).reshape(GRID, GRID, PATCH * PATCH * 3)
    x = prec.mm(patches, p["enc.patch_embed.w"]) + p["enc.patch_embed.b"]
    x = x + p["enc.pos_embed"]
    heads, window = int(p["enc.num_heads"]), int(p["enc.window"])
    globals_ = set(int(i) for i in p["enc.global_blocks"])
    for i in range(int(p["enc.n_blocks"])):
        if i in globals_ and i not in windowed:
            x = encoder_block(x, p, i, heads, 0, prec)
        else:
            # A global block run in windows reads its tables' middle rows.
            rows = 2 * window - 1 if i in globals_ else None
            x = encoder_block(x, p, i, heads, window, prec, rows)
    y = prec.mm(x, p["enc.neck.conv1.w"]).permute(2, 0, 1)     # [256,64,64]
    y = channel_norm(y, p, "enc.neck.ln1")
    y = F.conv2d(prec.r(y)[None],
                 prec.r(p["enc.neck.conv2.w"].permute(3, 2, 0, 1)),
                 padding=1)[0]
    return channel_norm(y, p, "enc.neck.ln2")


# ----------------------------------------------------------- prompt encoder
def fourier(coords01: torch.Tensor, p: Params) -> torch.Tensor:
    """Random-Fourier encoding of [..., 2] (x, y) in [0, 1]."""
    c = 2.0 * coords01 - 1.0
    c = 2.0 * math.pi * (c @ p["prompt.pe_gauss"])
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(p: Params) -> torch.Tensor:
    """[256, 64, 64] positions of the embedding grid's cell centres."""
    c = (torch.arange(GRID, device=p["prompt.pe_gauss"].device,
                      dtype=torch.float32) + 0.5) / GRID
    y, x = torch.meshgrid(c, c, indexing="ij")
    return fourier(torch.stack([x, y], dim=-1), p).permute(2, 0, 1)


def point_tokens(p: Params, point_xy: torch.Tensor) -> torch.Tensor:
    """One foreground point in 1024-space -> [2, 256]: the point and the
    padding point."""
    pe = fourier((point_xy + 0.5) / IMG, p) + p["prompt.point_embed.1"]
    return torch.stack([pe, p["prompt.not_a_point"]])


# ------------------------------------------------------------- mask decoder
def mha(q, k, v, p: Params, pre: str, heads: int, prec: Precision):
    """Projected multi-head attention of [Tq, C] queries on [Tk, C]."""
    qp, kp, vp = (prec.linear(t, p, f"{pre}.{nm}")
                  for t, nm in ((q, "q"), (k, "k"), (v, "v")))
    inner = qp.shape[1]
    hd = inner // heads
    out = []
    for h in range(heads):
        sl = slice(h * hd, (h + 1) * hd)
        att = torch.softmax(prec.mm(qp[:, sl], kp[:, sl].T)
                            / math.sqrt(hd), dim=-1)
        out.append(prec.mm(att, vp[:, sl]))
    return prec.linear(torch.cat(out, dim=1), p, f"{pre}.out")


def mlp3(x, p: Params, pre: str, prec: Precision):
    for li in range(3):
        x = prec.mm(x, p[f"{pre}.w{li}"]) + p[f"{pre}.b{li}"]
        if li < 2:
            x = torch.relu(x)
    return x


def decode(p: Params, embedding: torch.Tensor, pe: torch.Tensor,
           sparse: torch.Tensor, prec: Precision, multimask: bool = True):
    """One prompt's [P, 256] sparse tokens -> (low-resolution logits
    [M, 256, 256], predicted IoU [M]); M = 3 with ``multimask`` (mask
    tokens 1-3), else 1 (token 0)."""
    heads = int(p["dec.num_heads"])
    tokens = torch.cat([p["dec.iou_token"][None], p["dec.mask_tokens"],
                        sparse])                              # [7, 256]
    keys = embedding.reshape(PROMPT, -1).T + p["prompt.no_mask"]
    key_pe = pe.reshape(PROMPT, -1).T                          # [4096, 256]
    queries = tokens
    for i in range(int(p["dec.n_layers"])):
        pre = f"dec.layers.{i}"
        if i == 0:
            queries = mha(queries, queries, queries, p, f"{pre}.self_attn",
                          heads, prec)
        else:
            q = queries + tokens
            queries = queries + mha(q, q, queries, p, f"{pre}.self_attn",
                                    heads, prec)
        queries = layer_norm(queries, p[f"{pre}.ln1.scale"],
                             p[f"{pre}.ln1.bias"], DECODER_LN_EPS)
        queries = queries + mha(queries + tokens, keys + key_pe, keys, p,
                                f"{pre}.cross_t2i", heads, prec)
        queries = layer_norm(queries, p[f"{pre}.ln2.scale"],
                             p[f"{pre}.ln2.bias"], DECODER_LN_EPS)
        h = torch.relu(prec.mm(queries, p[f"{pre}.mlp.w1"])
                       + p[f"{pre}.mlp.b1"])
        queries = queries + prec.mm(h, p[f"{pre}.mlp.w2"]) \
            + p[f"{pre}.mlp.b2"]
        queries = layer_norm(queries, p[f"{pre}.ln3.scale"],
                             p[f"{pre}.ln3.bias"], DECODER_LN_EPS)
        keys = keys + mha(keys + key_pe, queries + tokens, queries, p,
                          f"{pre}.cross_i2t", heads, prec)
        keys = layer_norm(keys, p[f"{pre}.ln4.scale"], p[f"{pre}.ln4.bias"],
                          DECODER_LN_EPS)
    queries = queries + mha(queries + tokens, keys + key_pe, keys, p,
                            "dec.final_attn", heads, prec)
    queries = layer_norm(queries, p["dec.ln_final.scale"],
                         p["dec.ln_final.bias"], DECODER_LN_EPS)
    x = keys.T.reshape(1, PROMPT, GRID, GRID)
    x = F.conv_transpose2d(prec.r(x), prec.r(p["dec.up1.w"].permute(
        3, 2, 0, 1)), p["dec.up1.b"], stride=2)[0]           # [64, 128, 128]
    x = F.gelu(channel_norm(x, p, "dec.up_ln"))
    x = F.gelu(F.conv_transpose2d(prec.r(x[None]), prec.r(
        p["dec.up2.w"].permute(3, 2, 0, 1)), p["dec.up2.b"], stride=2)[0])
    n_mask = p["dec.mask_tokens"].shape[0]
    hyper = torch.stack([mlp3(queries[1 + j], p, f"dec.hyper.{j}", prec)
                         for j in range(n_mask)])             # [4, 32]
    masks = prec.mm(hyper, x.reshape(32, -1)).reshape(n_mask, 4 * GRID,
                                                      4 * GRID)
    iou = mlp3(queries[0], p, "dec.iou_head", prec)
    if multimask:
        return masks[1:], iou[1:]
    return masks[:1], iou[:1]


def upscale(low: torch.Tensor, orig_hw, input_hw) -> torch.Tensor:
    """[N, 256, 256] logits -> [N, H, W] at the original size: to
    1024x1024, crop the unpadded part, to the original size."""
    x = F.interpolate(low[:, None], size=(IMG, IMG), mode="bilinear",
                      align_corners=False, antialias=True)
    x = x[..., :input_hw[0], :input_hw[1]]
    return F.interpolate(x, size=tuple(orig_hw), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


# ---------------------------------------------------------- automatic masks
class Image(NamedTuple):
    embedding: torch.Tensor            # [256, 64, 64]
    low: List[torch.Tensor]            # per prompt batch [B, 3, 256, 256]
    iou: List[torch.Tensor]            # per prompt batch [B, 3]
    kept: List[dict]


def stability(low: torch.Tensor, offset: float) -> float:
    inter = float((low > offset).sum())
    union = float((low > -offset).sum())
    return inter / max(union, 1.0)


def automatic_masks(p: Params, image: torch.Tensor, settings: dict,
                    prec: Precision, windowed: Sequence[int] = (),
                    grid_offset: float = 0.5) -> Image:
    """Automatic masks of one [H, W, 3] image (pixels 0..255) under
    ``settings`` (points_per_side, points_per_batch, pred_iou_thresh,
    stability_offset, stability_thresh, nms_iou, min_area).  Kept masks
    are dicts with the prompt's index ``prompt``, the mask's ``slot``
    (0-2), ``predicted_iou``, ``stability_score``, ``area`` and the
    boolean ``segmentation``.  The grid's points lie at ``(i +
    grid_offset) / n`` of each side; another offset than 0.5 (and
    ``windowed``, :func:`encode`) is a fault for the benchmark's check."""
    h, w = image.shape[:2]
    scale = IMG / max(h, w)
    input_hw = (int(round(h * scale)), int(round(w * scale)))
    with torch.no_grad():
        emb = encode(p, preprocess(image), prec, windowed)
        pe = dense_pe(p)
        n = settings["points_per_side"]
        g = (np.arange(n) + grid_offset) / n
        pts = np.stack(np.meshgrid(g * w, g * h), axis=-1).reshape(-1, 2)
        lows, ious = [], []
        bsz = settings["points_per_batch"]
        for s0 in range(0, len(pts), bsz):
            batch = [decode(p, emb, pe, point_tokens(p, torch.as_tensor(
                xy * scale, dtype=torch.float32, device=emb.device)), prec)
                for xy in pts[s0:s0 + bsz]]
            lows.append(torch.stack([b[0] for b in batch]))
            ious.append(torch.stack([b[1] for b in batch]))
        cands = []
        for bi, (low, iou) in enumerate(zip(lows, ious)):
            for j in range(low.shape[0]):
                for m in range(low.shape[1]):
                    score = float(iou[j, m])
                    if score < settings["pred_iou_thresh"]:
                        continue
                    stab = stability(low[j, m], settings["stability_offset"])
                    if stab < settings["stability_thresh"]:
                        continue
                    seg = upscale(low[j, m][None], (h, w), input_hw)[0] > 0
                    area = int(seg.sum())
                    if area < settings["min_area"]:
                        continue
                    cands.append({"prompt": bi * bsz + j, "slot": m,
                                  "predicted_iou": score,
                                  "stability_score": stab, "area": area,
                                  "segmentation": seg})
        cands.sort(key=lambda r: -r["predicted_iou"])
        kept: List[dict] = []
        for r in cands:
            if kept:
                stack = torch.stack([k["segmentation"] for k in kept])
                inter = (stack & r["segmentation"]).sum(dim=(1, 2)).tolist()
                areas = [k["area"] for k in kept]
                if any(u and i / u > settings["nms_iou"] for i, u in
                       ((i, r["area"] + a - i)
                        for i, a in zip(inter, areas))):
                    continue
            kept.append(r)
    return Image(emb, lows, ious, kept)

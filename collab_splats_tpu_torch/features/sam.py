"""Segment Anything (SAM) as functions of a parameter dict: the image
encoder, the prompt encoder and the two-way mask decoder.

Counterpart of the JAX package's ``features/sam.py``, with its parameter
names and layout (``scripts/convert_sam.py``; load them with
``vit.params_from_numpy``):

* :func:`sam_encoder_forward`: the ViT image encoder (windowed blocks with
  decomposed relative positions, global blocks at the stage ends, a neck
  of two convolutions with channel LayerNorms) -> [256, 64, 64];
* :func:`encode_boxes`, :func:`encode_points`, :func:`dense_pe`: prompts
  in random-Fourier positional encoding;
* :func:`mask_decoder_forward`: the two-way transformer, the hypernetwork
  MLPs, the output upscaling with the mask product (:func:`upscale_masks`)
  and the IoU head, for a batch of prompts at once (JAX maps one prompt at
  a time).

The upscaling's two transposed convolutions, channel LayerNorm, GELUs and
mask product are one hand-written kernel on the card
(``ops/cuda/sam_upscale.py``) and :func:`upscale_masks_plain`
(``F.conv_transpose2d``) on the CPU.  The other convolutions are
``F.conv2d`` under the package's TF32-off setting; every resize is
``decoder.resize_bilinear``, JAX's linear resize.
The two-way transformer's LayerNorms take ``mask_decoder_forward``'s
``ln_eps``: the JAX package's 1e-6 by default, SAM's own 1e-5
(:data:`DECODER_LN_EPS`) for a published checkpoint.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.cuda import sam_upscale
from ..utils import profiling
from .decoder import resize_bilinear
from .vit import Params, layer_norm

IMG_SIZE = 1024
EMBED_HW = 64
PROMPT_DIM = 256
# SAM's two-way transformer LayerNorms are nn.LayerNorm at its default eps;
# its encoder's and channel LayerNorms (neck, upscaling) take 1e-6.
DECODER_LN_EPS = 1e-5


# ------------------------------------------------------------ image encoder


def _rel_pos_bias(q_hw: int, k_hw: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """[q_hw, k_hw, C] decomposed relative positions (SAM's get_rel_pos),
    the table resized linearly when its length is not 2 * max - 1."""
    max_rel = 2 * max(q_hw, k_hw) - 1
    rp = rel_pos
    if rp.shape[0] != max_rel:
        rp = resize_bilinear(rp, (max_rel, rp.shape[1]))
    dev = rel_pos.device
    qc = torch.arange(q_hw, device=dev, dtype=torch.float32)[:, None] \
        * max(k_hw / q_hw, 1.0)
    kc = torch.arange(k_hw, device=dev, dtype=torch.float32)[None, :] \
        * max(q_hw / k_hw, 1.0)
    rel = (qc - kc) + (k_hw - 1) * max(q_hw / k_hw, 1.0)
    return rp[rel.to(torch.int64)]


def _windowed_attention(x, p, pre, num_heads):
    """Attention within each [h, w, C] block of a batch [B, h, w, C] (the
    windows, or the whole map for a global block), with decomposed
    relative positions."""
    b, h, w, c = x.shape
    hd = c // num_heads
    qkv = (x.reshape(b, h * w, c) @ p[f"{pre}.qkv.w"] + p[f"{pre}.qkv.b"])
    qkv = qkv.reshape(b, h * w, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                  # [B, nh, HW, hd]
    att = (q * hd ** -0.5) @ k.transpose(-1, -2)
    rh = _rel_pos_bias(h, h, p[f"{pre}.rel_pos_h"])    # [h, h, hd]
    rw = _rel_pos_bias(w, w, p[f"{pre}.rel_pos_w"])
    rq = q.reshape(b, num_heads, h, w, hd)
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", rq, rh)
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", rq, rw)
    att = att.reshape(b, num_heads, h, w, h, w) \
        + bias_h[..., :, None] + bias_w[..., None, :]
    att = torch.softmax(att.reshape(b, num_heads, h * w, h * w), dim=-1)
    o = (att @ v).transpose(1, 2).reshape(b, h * w, c)
    return (o @ p[f"{pre}.proj.w"] + p[f"{pre}.proj.b"]).reshape(b, h, w, c)


def _encoder_block(x, p, i, num_heads, window: int):
    """One block on the [H, W, C] map; ``window`` 0 is a global block."""
    pre = f"enc.blocks.{i}"
    h0, w0, c = x.shape
    shortcut = x
    x = layer_norm(x, p[f"{pre}.ln1.scale"], p[f"{pre}.ln1.bias"])
    if window > 0:
        x = F.pad(x, (0, 0, 0, (-w0) % window, 0, (-h0) % window))
        hp, wp = x.shape[:2]
        x = x.reshape(hp // window, window, wp // window, window, c)
        x = x.permute(0, 2, 1, 3, 4).reshape(-1, window, window, c)
        x = _windowed_attention(x, p, f"{pre}.attn", num_heads)
        x = x.reshape(hp // window, wp // window, window, window, c)
        x = x.permute(0, 2, 1, 3, 4).reshape(hp, wp, c)[:h0, :w0]
    else:
        x = _windowed_attention(x[None], p, f"{pre}.attn", num_heads)[0]
    x = shortcut + x
    h = layer_norm(x, p[f"{pre}.ln2.scale"], p[f"{pre}.ln2.bias"])
    h = F.gelu(h @ p[f"{pre}.mlp.w1"] + p[f"{pre}.mlp.b1"])
    return x + (h @ p[f"{pre}.mlp.w2"] + p[f"{pre}.mlp.b2"])


def sam_encoder_forward(params: Params, image: torch.Tensor) -> torch.Tensor:
    """SAM's ViT image encoder: [1024, 1024, 3] ImageNet-normalised image
    -> [256, 64, 64] embedding."""
    ps = 16
    h = IMG_SIZE // ps
    patches = image.reshape(h, ps, h, ps, 3).permute(0, 2, 1, 3, 4)
    x = patches.reshape(h, h, -1) @ params["enc.patch_embed.w"] \
        + params["enc.patch_embed.b"]                  # [64, 64, C]
    x = x + params["enc.pos_embed"]
    window = int(params["enc.window"])
    global_idx = set(params["enc.global_blocks"].tolist())
    heads = int(params["enc.num_heads"])
    for i in range(int(params["enc.n_blocks"])):
        x = _encoder_block(x, params, i, heads,
                           0 if i in global_idx else window)
    # Neck: 1x1 conv -> LN2d -> 3x3 conv -> LN2d (channel-last here).
    x = x @ params["enc.neck.conv1.w"]                 # [64, 64, 256]
    x = layer_norm(x, params["enc.neck.ln1.scale"],
                   params["enc.neck.ln1.bias"])
    x = F.conv2d(x.permute(2, 0, 1)[None],
                 params["enc.neck.conv2.w"].permute(3, 2, 0, 1),
                 padding=1)[0].permute(1, 2, 0)
    x = layer_norm(x, params["enc.neck.ln2.scale"],
                   params["enc.neck.ln2.bias"])
    return x.permute(2, 0, 1).contiguous()


# ----------------------------------------------------------- prompt encoder


def _pe_encode(coords01: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    """Random-Fourier positional encoding of [..., 2] coords in [0, 1]."""
    proj = (2.0 * math.pi) * ((2.0 * coords01 - 1.0) @ gauss)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def dense_pe(params: Params) -> torch.Tensor:
    """[256, 64, 64] positional encoding of the embedding grid."""
    gauss = params["prompt.pe_gauss"]
    c = (torch.arange(EMBED_HW, device=gauss.device, dtype=torch.float32)
         + 0.5) / EMBED_HW
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    pe = _pe_encode(torch.stack([gx, gy], dim=-1), gauss)   # (x, y) order
    return pe.permute(2, 0, 1)


def encode_boxes(params: Params, boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """[B, 4] pixel boxes (1024-space) -> [B, 2, 256] sparse embeddings."""
    corners = boxes_xyxy.reshape(-1, 2, 2) + 0.5
    pe = _pe_encode(corners / IMG_SIZE, params["prompt.pe_gauss"])
    corner_embed = torch.stack([params["prompt.point_embed.2"],
                                params["prompt.point_embed.3"]])
    return pe + corner_embed


def encode_points(params: Params, pts: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """[B, N, 2] pixel points and [B, N] labels (1 foreground, 0
    background, -1 padding) -> [B, N + 1, 256] sparse embeddings, with the
    trailing not-a-point pad SAM appends when no box prompt is given."""
    pe = _pe_encode((pts + 0.5) / IMG_SIZE, params["prompt.pe_gauss"])
    lab = labels[..., None]
    nap = params["prompt.not_a_point"]
    zero = torch.zeros((), device=pe.device)
    pe = torch.where(lab == -1, nap, pe)
    pe = pe + torch.where(lab == 1, params["prompt.point_embed.1"], zero)
    pe = pe + torch.where(lab == 0, params["prompt.point_embed.0"], zero)
    pad = nap.expand(pe.shape[0], 1, PROMPT_DIM)
    return torch.cat([pe, pad], dim=1)


# ------------------------------------------------------------- mask decoder


def _attn(q, k, v, p, pre, num_heads):
    """Projected multi-head attention on token sets [B, Tq, C] x [B, Tk, C]."""
    cq = p[f"{pre}.q.w"].shape[1]
    hd = cq // num_heads

    def heads(x, nm):
        y = x @ p[f"{pre}.{nm}.w"] + p[f"{pre}.{nm}.b"]
        return y.reshape(y.shape[0], -1, num_heads, hd).transpose(1, 2)

    qp, kp, vp = heads(q, "q"), heads(k, "k"), heads(v, "v")
    att = torch.softmax((qp @ kp.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    o = (att @ vp).transpose(1, 2).reshape(q.shape[0], -1, cq)
    return o @ p[f"{pre}.out.w"] + p[f"{pre}.out.b"]


def _twoway_block(tokens, image, token_pe, image_pe, p, i, heads,
                  skip_first_pe: bool, eps: float):
    pre = f"dec.layers.{i}"
    # 1. Token self-attention; SAM's first layer skips the positions and
    # the residual (the queries are replaced, not added to).
    if skip_first_pe:
        tokens = _attn(tokens, tokens, tokens, p, f"{pre}.self_attn", heads)
    else:
        q = tokens + token_pe
        tokens = tokens + _attn(q, q, tokens, p, f"{pre}.self_attn", heads)
    tokens = layer_norm(tokens, p[f"{pre}.ln1.scale"],
                        p[f"{pre}.ln1.bias"], eps)
    # 2. Token -> image cross attention.
    tokens = tokens + _attn(tokens + token_pe, image + image_pe, image, p,
                            f"{pre}.cross_t2i", heads)
    tokens = layer_norm(tokens, p[f"{pre}.ln2.scale"],
                        p[f"{pre}.ln2.bias"], eps)
    # 3. MLP on the tokens.
    h = torch.relu(tokens @ p[f"{pre}.mlp.w1"] + p[f"{pre}.mlp.b1"])
    tokens = tokens + (h @ p[f"{pre}.mlp.w2"] + p[f"{pre}.mlp.b2"])
    tokens = layer_norm(tokens, p[f"{pre}.ln3.scale"],
                        p[f"{pre}.ln3.bias"], eps)
    # 4. Image -> token cross attention.
    image = image + _attn(image + image_pe, tokens + token_pe, tokens, p,
                          f"{pre}.cross_i2t", heads)
    image = layer_norm(image, p[f"{pre}.ln4.scale"], p[f"{pre}.ln4.bias"],
                       eps)
    return tokens, image


def _mlp3(x, p, pre):
    """The decoder's three-layer ReLU MLPs (hypernetworks, IoU head)."""
    for li in range(3):
        x = x @ p[f"{pre}.w{li}"] + p[f"{pre}.b{li}"]
        if li < 2:
            x = torch.relu(x)
    return x


def mask_decoder_forward(
    params: Params,
    image_embedding: torch.Tensor,     # [256, 64, 64]
    image_pe: torch.Tensor,            # [256, 64, 64]
    sparse_prompts: torch.Tensor,      # [B, P, 256]
    multimask: bool = False,
    ln_eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAM's two-way mask decoder over a batch of prompts; ``ln_eps`` is
    its two-way transformer's LayerNorm eps.

    Returns (low_res_masks [B, M, 256, 256], iou_pred [B, M]); M = 3 with
    ``multimask``, else 1 (SAM's mask slot 0)."""
    heads = int(params["dec.num_heads"])
    n_mask_tokens = params["dec.mask_tokens"].shape[0]
    b = sparse_prompts.shape[0]
    tokens = torch.cat([
        params["dec.iou_token"][None, None].expand(b, 1, PROMPT_DIM),
        params["dec.mask_tokens"][None].expand(b, -1, -1),
        sparse_prompts], dim=1)
    # SAM adds the dense (no-mask) embedding to the image features.
    src = image_embedding.reshape(PROMPT_DIM, -1).T + params["prompt.no_mask"]
    im = src[None].expand(b, -1, -1)                      # [B, 4096, 256]
    pe = image_pe.reshape(PROMPT_DIM, -1).T[None]
    t = tokens
    for i in range(int(params["dec.n_layers"])):
        t, im = _twoway_block(t, im, tokens, pe, params, i, heads,
                              skip_first_pe=(i == 0), eps=ln_eps)
    # Final token -> image attention and LayerNorm.
    t = t + _attn(t + tokens, im + pe, im, params, "dec.final_attn", heads)
    t = layer_norm(t, params["dec.ln_final.scale"],
                   params["dec.ln_final.bias"], ln_eps)

    hyper = torch.stack([_mlp3(t[:, 1 + j], params, f"dec.hyper.{j}")
                         for j in range(n_mask_tokens)], dim=1)  # [B, M, 32]
    masks = upscale_masks(params, im, hyper)
    iou = _mlp3(t[:, 0], params, "dec.iou_head")
    if multimask:
        return masks[:, 1:], iou[:, 1:]
    return masks[:, :1], iou[:, :1]


def upscale_masks_plain(params: Params, im: torch.Tensor,
                        hyper: torch.Tensor) -> torch.Tensor:
    """The decoder's image features ``im`` [B, 4096, 256] upscaled 4x
    (convT stride 2 -> LN2d -> GELU -> convT stride 2 -> GELU; weights
    stored as the forward conv's HWIO) and multiplied by the hypernetwork
    outputs ``hyper`` [B, M, 32] -> mask logits [B, M, 256, 256]."""
    b = im.shape[0]
    x = im.transpose(1, 2).reshape(b, PROMPT_DIM, EMBED_HW, EMBED_HW)
    x = F.conv_transpose2d(x, params["dec.up1.w"].permute(3, 2, 0, 1),
                           params["dec.up1.b"], stride=2)
    x = layer_norm(x.permute(0, 2, 3, 1), params["dec.up_ln.scale"],
                   params["dec.up_ln.bias"]).permute(0, 3, 1, 2)
    x = F.gelu(x)
    x = F.gelu(F.conv_transpose2d(
        x, params["dec.up2.w"].permute(3, 2, 0, 1), params["dec.up2.b"],
        stride=2))                                        # [B, 32, 256, 256]
    return (hyper @ x.flatten(2)).reshape(b, hyper.shape[1], *x.shape[2:])


def upscale_masks(params: Params, im: torch.Tensor,
                  hyper: torch.Tensor) -> torch.Tensor:
    """:func:`upscale_masks_plain` on the CPU; on the card the fused kernel
    (``ops/cuda/sam_upscale.py``), which raises on what it does not take.
    Recorded as the span ``sam.upscale``; the counter ``sam.fused_up``
    counts the prompts the kernel ran (0 on the CPU)."""
    with profiling.span("sam.upscale"):
        if im.device.type == "cpu":
            profiling.count("sam.fused_up", 0)
            return upscale_masks_plain(params, im, hyper)
        return sam_upscale.upscale_masks(params, im, hyper)


def postprocess_masks(low_res: torch.Tensor, orig_hw: Tuple[int, int],
                      input_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, M, 256, 256] logits -> [B, M, H, W] at the original size."""
    x = resize_bilinear(low_res, (IMG_SIZE, IMG_SIZE), axes=(2, 3))
    x = x[:, :, : input_hw[0], : input_hw[1]]
    return resize_bilinear(x, tuple(orig_hw), axes=(2, 3))

"""Frozen float32 operation counts of SAM's automatic masks, from the
configuration's widths alone.  A product counts 2 operations per
multiply-add: the linear maps, the attention's two products, the
relative-position terms, the convolutions and the mask products; the
norms, softmaxes and activations are left out."""

from __future__ import annotations

from typing import Sequence


def encoder(dim: int, depth: int, heads: int, global_blocks: Sequence[int],
            window: int, grid: int = 64, patch: int = 16,
            mlp_ratio: int = 4, out: int = 256) -> int:
    """One image through the ViT encoder: the patch embedding, the blocks
    (a windowed block's attention and projections over the map padded to
    whole windows, its MLP over the unpadded tokens), the neck's 1x1 and
    3x3 convolutions."""
    n = grid * grid
    side = grid + (-grid) % window
    hd = dim // heads
    ops = 2 * n * patch * patch * 3 * dim
    for i in range(depth):
        if i in global_blocks:
            tokens, span, groups = n, grid, 1
        else:
            tokens, span, groups = side * side, window, (side // window) ** 2
        per = tokens // groups
        ops += 2 * tokens * dim * 3 * dim                  # qkv
        ops += 2 * 2 * groups * heads * per * per * hd     # q k, att v
        ops += 2 * 2 * tokens * heads * span * hd          # q R_h, q R_w
        ops += 2 * tokens * dim * dim                      # projection
        ops += 2 * 2 * n * dim * mlp_ratio * dim           # MLP
    return ops + 2 * n * dim * out + 2 * n * out * out * 9


def _attention(tq: int, tk: int, dim: int, inner: int) -> int:
    """Projected attention of tq queries on tk keys at ``inner`` width:
    the four projections and the two products."""
    return 2 * (tq * dim * inner + 2 * tk * dim * inner
                + 2 * tq * tk * inner + tq * inner * dim)


def decoder_per_prompt(dim: int = 256, depth: int = 2, mlp: int = 2048,
                       downsample: int = 2, tokens: int = 7,
                       mask_tokens: int = 4, grid: int = 64,
                       upscale: Sequence[int] = (64, 32)) -> int:
    """One point prompt (its token, the padding point, the IoU token and
    four mask tokens: 7 tokens) through the two-way transformer, the final
    attention, the upscaling's two 2x2 stride-2 transposed convolutions,
    the hypernetworks, the mask products and the IoU head."""
    n = grid * grid
    inner = dim // downsample
    ops = 0
    for _ in range(depth):
        ops += _attention(tokens, tokens, dim, dim)
        ops += _attention(tokens, n, dim, inner)
        ops += 2 * 2 * tokens * dim * mlp
        ops += _attention(n, tokens, dim, inner)
    ops += _attention(tokens, n, dim, inner)
    c1, c2 = upscale
    ops += 2 * (2 * grid) ** 2 * c1 * dim + 2 * (4 * grid) ** 2 * c2 * c1
    mlp3 = 2 * (dim * dim * 2)
    ops += mask_tokens * (mlp3 + 2 * dim * c2) + mlp3 + 2 * dim * mask_tokens
    return ops + 2 * mask_tokens * c2 * (4 * grid) ** 2


def image(cfg: dict) -> int:
    """One image's operations under a configuration file of
    ``configs/sam-*.json``: the encoder and every prompt of the grid."""
    e, d = cfg["image_encoder"], cfg["mask_decoder"]
    prompts = cfg["auto_mask"]["points_per_side"] ** 2
    return encoder(e["embed_dim"], e["depth"], e["num_heads"],
                   e["global_attn_indexes"], e["window_size"],
                   e["img_size"] // e["patch_size"], e["patch_size"],
                   e["mlp_ratio"], e["out_chans"]) + prompts * \
        decoder_per_prompt(d["transformer_dim"], d["depth"], d["mlp_dim"],
                           d["attention_downsample_rate"],
                           tokens=1 + d["num_multimask_outputs"] + 1 + 2,
                           mask_tokens=d["num_multimask_outputs"] + 1,
                           grid=e["img_size"] // e["patch_size"],
                           upscale=(d["transformer_dim"] // 4,
                                    d["transformer_dim"] // 8))

"""Frozen float32 operation counts of the feature towers' pass over one
frame, from the configuration's widths and the frame's size alone.  A
product counts 2 operations per multiply-add: the patch embeddings, the
blocks' linear maps, the attention's two products, the MaskCLIP value path
and the projection; the resizes, norms, softmaxes and activations are
left out."""

from __future__ import annotations

from typing import Tuple


def grid(height: int, width: int, resolution: int, patch: int
         ) -> Tuple[int, int]:
    """The patch grid (rows, columns) of a frame whose longest edge is
    brought to ``resolution`` and then down to multiples of ``patch``."""
    scale = resolution / max(height, width)
    nh, nw = int(round(height * scale)), int(round(width * scale))
    return max(nh // patch, 1), max(nw // patch, 1)


def block(tokens: int, dim: int, mlp: int) -> int:
    """One pre-norm block: q, k, v, the two attention products, the
    output projection and the MLP."""
    return (2 * tokens * dim * 3 * dim + 2 * 2 * tokens * tokens * dim
            + 2 * tokens * dim * dim + 2 * 2 * tokens * dim * mlp)


def maskclip(tokens: int, dim: int, layers: int, mlp: int, patch: int,
             embed: int) -> int:
    """MaskCLIP's visual pass over ``tokens`` (the class token included):
    the patch embedding, ``layers - 1`` blocks, the last block's value
    path (v and the output projection) and MLP, and the projection."""
    ops = 2 * (tokens - 1) * patch * patch * 3 * dim
    ops += (layers - 1) * block(tokens, dim, mlp)
    ops += 2 * 2 * tokens * dim * dim + 2 * 2 * tokens * dim * mlp
    return ops + 2 * tokens * dim * embed


def dinov2(tokens: int, dim: int, layers: int, mlp: int, patch: int) -> int:
    """DINOv2's pass over ``tokens``: the patch embedding and the
    blocks."""
    return 2 * (tokens - 1) * patch * patch * 3 * dim \
        + layers * block(tokens, dim, mlp)


def tokens(cfg: dict, tower: str, height: int, width: int) -> int:
    """A tower's tokens on a frame, the class token included."""
    t = cfg[tower]
    rows, cols = grid(height, width, t["resolution"], t["patch_size"])
    return rows * cols + 1


def image(cfg: dict, height: int, width: int) -> int:
    """One frame's operations through both towers of
    ``configs/maskclip-*.json``."""
    c, d = cfg["clip"], cfg["dinov2"]
    return maskclip(tokens(cfg, "clip", height, width), c["width"],
                    c["layers"], c["mlp_width"], c["patch_size"],
                    c["embed_dim"]) + \
        dinov2(tokens(cfg, "dinov2", height, width), d["width"],
               d["layers"], d["mlp_width"], d["patch_size"])

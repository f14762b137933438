"""Useful float32 operations of a whole training step, for the whole-step
share of the card's peak (``mfu.*``).

Counted from the inputs and the reference binning, never from what the
program computes: projection and SH per *alive* Gaussian, compositing per
(pixel, window slot) pair of the reference binning, the loss per pixel,
Adam per parameter element of the alive rows.  A program that stops
computing dead rows, or culls pairs it need not composite, therefore does
not lower the count.  The per-element constants are the operations of the
plain formulas (``reference/``), forward; a backward is counted as twice
its forward.
"""

from __future__ import annotations

from . import (composite_batched_bwd, composite_batched_fwd,
               segment_sum_sorted)

PROJECT_FWD = 330        # EWA projection, depth plane and normal
SH_BASIS_FWD = {1: 0, 4: 12, 9: 30, 16: 55}   # basis of the unit direction
LOSS_PIXEL_FWD = 800     # blend, L1, SSIM's five filtered maps, depth-normal
ADAM_ELEMENT = 13        # dead-row mask, two moments, sqrt, divide, update
COSINE_PER_CHANNEL = 6   # dot, two squared norms (per channel of a pixel)


def sh_fwd(bases: int) -> int:
    """Colours of one Gaussian: the normalised direction (10), its basis,
    one FMA per basis and channel, the shift and clamp (6); the sigmoid
    (12) at degree 0."""
    if bases <= 1:
        return 12
    return 10 + SH_BASIS_FWD[bases] + 2 * 3 * bases + 6


def features_fwd(height: int, width: int, latent: int, hidden: int,
                 dims: dict, main: str) -> int:
    """The decoded latents' distillation: the antialiased resize of the
    latent map to the main tower's map (two passes, each tap of the
    triangle kernel one FMA), the decoder's two layers, the cosine terms;
    a tower at another size than the main is resized once more."""
    _, mh, mw = dims[main]
    taps_h = 2 * max(height // mh, 1)
    taps_w = 2 * max(width // mw, 1)
    ops = 2 * latent * (mh * width * taps_h + mh * mw * taps_w)
    heads = sum(c for c, _, _ in dims.values())
    ops += 2 * mh * mw * (latent * hidden + hidden * heads)
    ops += COSINE_PER_CHANNEL * sum(c * h * w for c, h, w in dims.values())
    return ops


def train_step(alive: int, bases: int, v: int, tiles: int, k: int,
               masked_slots: int, live_pairs: int, pixels: int,
               adam_elements: int, features: int = 0) -> float:
    """Useful operations of one training step.  ``features`` is
    :func:`features_fwd` of a rade-features step (0 otherwise)."""
    fwd = composite_batched_fwd.count(tiles, k, v, masked_slots,
                                      live_pairs)[1]
    bwd = composite_batched_bwd.count(tiles, k, v, masked_slots,
                                      live_pairs)[1]
    per_gauss = 3 * (PROJECT_FWD + sh_fwd(bases))
    # The window-row gather's backward: one add per element of each row.
    row_sums = segment_sum_sorted.count(masked_slots, 9 + v, alive)[1]
    return (alive * per_gauss + fwd + bwd + row_sums
            + 3 * LOSS_PIXEL_FWD * pixels + 3 * features
            + ADAM_ELEMENT * adam_elements)


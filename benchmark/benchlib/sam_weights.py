"""Seeded SAM decoder weights whose automatic masks are localised.

Random weights drawn at SAM's widths make near-whole-image masks, and the
share of them that passes the automatic masks' filter swings with the
seed, so a cell on them would time a filter that keeps nothing, or
everything.  :func:`localise` rewrites the mask decoder and the prompt
encoder of a parameter dict (``reference/sam.py::init_params``'s layout)
into a constructed network, at every width and through every operation of
SAM's decoder, whose masks on a point grid give the filter what a trained
one gives it:

* every prompt gets three nested masks, blobs around its point: the
  image-to-token attention of the second two-way layer attends to the
  point's token by the random-Fourier kernel ``pe(cell) . pe(point)``
  over ``KERNEL_FREQS`` frequencies (seven in each head), with the padding
  token as a sink; the point's value lands in one key channel, which the
  upscaling and the hypernetworks read with a threshold for each slot
  (``SLOT_KEYS``), steep enough that nearly every mask's stability score
  clears 0.95;
* the image's embedding shifts each mask's edge: the key channel also
  holds one channel of the embedding, at ``CONTENT_GAIN``;
* the predicted IoU of slot j is ``0.88 + IOU_SLOPE * (tau - z_j)``,
  where ``z_j`` is a sum of ``HASH_FREQS`` unit sinusoids of the point's
  position at high frequencies (the first two-way layer's token
  self-attention copies them from the point's token to the IoU token), in
  units of its standard deviation; ``tau`` is its ``PASS_SHARE`` quantile
  under a normal law.  So about ``PASS_SHARE`` of each slot's masks pass,
  on any seed: the phases are equidistributed over a grid of points;
* every other weight keeps its seeded draw times ``EPS``, so each
  operation still moves the outputs.

The image encoder is not touched.  Channel plan of the 256-wide decoder
(a channel of ``pe`` is ``sin`` of frequency k at k, ``cos`` at 128 + k):
frequencies ``[0, 56)`` the kernel, ``[56, 64)`` zero (their sine
channels are 0 on every point and cell: ``TAG``, ``IDENT``, ``BLOB``;
``ONE``, a cosine channel, is 1), ``[64, 96)`` the position hash, drawn
at ``HASH_SCALE``, ``[96, 128)`` the tokens' own content.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

EPS = 0.01
KERNEL_FREQS = 56
HASH_FREQS = 32
# Head h's kernel frequencies are drawn at KERNEL_SCALE * HEAD_RATIO ** h:
# its blob is 1 / HEAD_RATIO times the last head's, so the number of heads
# that attend to the point falls off gradually with the distance.
KERNEL_SCALE = 2.4
HEAD_RATIO = 0.8
TAG, IDENT, BLOB = 56, 57, 58
ONE = 128 + 56
HASH = list(range(64, 96)) + list(range(192, 224))
CONTENT = list(range(96, 128)) + list(range(224, 256))
# The share of each slot's masks whose predicted IoU reaches 0.88.
PASS_SHARE = 0.05
# HASH_SCALE spreads the hash's phases over a 32x32 grid; float32 rounds a
# phase to about 1e-7 of its size, and the IoU to IOU_SLOPE times that.
IOU_SLOPE = 0.005
HASH_SCALE = 16.0
# The image-to-token attention: a head's logit on the point is
# KERNEL_GAIN * (kernel + 1) (seven cosines, at most 7), on the sink
# KERNEL_GAIN * SINK; the point's value lands in the blob's key channel
# times BLOB_GAIN.
KERNEL_GAIN = 2.0
SINK = 6.5
BLOB_GAIN = 0.15
# Per multimask slot (1-3; slot 0 as slot 2): the key channel's value at a
# mask's edge, and the logits' slope there.
SLOT_KEYS = {0: 8.6, 1: 11.0, 2: 8.6, 3: 5.6}
# The embedding's share in the blob's key channel.
CONTENT_GAIN = 0.35
SLOPE = 1000.0

Params = Dict[str, torch.Tensor]


def localise(p: Params, generator: torch.Generator) -> None:
    """Rewrite ``p``'s decoder and prompt encoder in place (see the
    module's docstring); ``generator`` draws the frequencies and
    phases."""
    dev = p["dec.iou_token"].device
    dim = p["dec.iou_token"].shape[0]

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    for k, v in p.items():
        if (k.startswith("dec.") or k.startswith("prompt.")) \
                and v.is_floating_point() and not k.endswith(".scale"):
            v.mul_(EPS)

    # Frequencies: the kernel's, none, the hash's, the content's.
    g = p["prompt.pe_gauss"]
    per = KERNEL_FREQS // 8
    g[:, :KERNEL_FREQS] = randn(2, KERNEL_FREQS) * torch.tensor(
        [KERNEL_SCALE * HEAD_RATIO ** (k // per)
         for k in range(KERNEL_FREQS)], device=dev)
    g[:, KERNEL_FREQS:64] = 0.0
    g[:, 64:64 + HASH_FREQS] = HASH_SCALE * randn(2, HASH_FREQS)
    g[:, 96:] = randn(2, 32)

    # Tokens: the IoU token and the point carry the tag, the point its
    # identity; every token has content of its own.
    content = torch.tensor(CONTENT, device=dev)
    p["dec.iou_token"][TAG] = 8.0
    p["dec.iou_token"][content] = randn(len(CONTENT))
    p["prompt.point_embed.1"][TAG] = 8.0
    p["prompt.point_embed.1"][IDENT] = 8.0
    p["prompt.point_embed.1"][content] = randn(len(CONTENT))
    for j in range(p["dec.mask_tokens"].shape[0]):
        p["dec.mask_tokens"][j, content] = randn(len(CONTENT))
    p["prompt.not_a_point"][content] = randn(len(CONTENT))
    # The padding token is the image-to-token attention's sink.
    p["prompt.not_a_point"][ONE] = SINK

    # First layer's token self-attention (8 heads of 32): heads 0 and 3
    # join the tagged tokens and copy the hash channels; heads 1 and 2
    # attend each token to itself by its content and copy its identity.
    pre = "dec.layers.0.self_attn"
    hd = p[f"{pre}.q.w"].shape[1] // 8
    for h, chans in ((0, HASH[:32]), (3, HASH[32:])):
        for w in ("q", "k"):
            p[f"{pre}.{w}.w"][TAG, h * hd] = 2.0
        for i, c in enumerate(chans):
            p[f"{pre}.v.w"][c, h * hd + i] = 1.0
            p[f"{pre}.out.w"][h * hd + i, c] = 1.0
    for i, c in enumerate(CONTENT):
        for w in ("q", "k"):
            p[f"{pre}.{w}.w"][c, hd + i] = 1.8
    p[f"{pre}.v.w"][IDENT, hd] = 1.0
    p[f"{pre}.out.w"][hd, IDENT] = 1.0

    # Keys after the first layer: nothing of the embedding where the
    # kernel reads.
    kernel = list(range(KERNEL_FREQS)) + [128 + k for k in
                                           range(KERNEL_FREQS)]
    p["dec.layers.0.ln4.scale"][torch.tensor(kernel + [ONE], device=dev)] \
        = 0.0
    p["dec.layers.0.ln4.scale"][BLOB] = CONTENT_GAIN

    # Second layer's image-to-token attention (8 heads of 16): the
    # kernel over seven frequencies a head, the sink's channel, the
    # point's identity as the value, into the blob's key channel.
    pre = "dec.layers.1.cross_i2t"
    hd = p[f"{pre}.q.w"].shape[1] // 8
    w_k = math.sqrt(KERNEL_GAIN * math.sqrt(hd))
    for h in range(8):
        for i in range(per):
            k = h * per + i
            for w in ("q", "k"):
                p[f"{pre}.{w}.w"][k, h * hd + 2 * i] = w_k
                p[f"{pre}.{w}.w"][128 + k, h * hd + 2 * i + 1] = w_k
        for w in ("q", "k"):
            p[f"{pre}.{w}.w"][ONE, h * hd + 2 * per] = w_k
        p[f"{pre}.v.w"][IDENT, h * hd] = 1.0
        p[f"{pre}.out.w"][h * hd, BLOB] = BLOB_GAIN

    # Upscaling: one channel follows the blob's key, one is constant, both
    # alike at every kernel position (the hypernetworks' large weights on
    # them would magnify any difference between positions).
    p["dec.up1.w"][:, :, :2] = 0.0
    p["dec.up2.w"][:, :, :2] = 0.0
    p["dec.up1.w"][:, :, 0, BLOB] = 1.0
    p["dec.up1.b"][1] = 16.0
    p["dec.up2.w"][:, :, 0, 0] = 1.0
    p["dec.up2.b"][1] = 1.0
    one = torch.nn.functional.gelu(torch.tensor(1.0)).item()

    # Hypernetworks: a constant output a slot, its threshold on the
    # blob's key channel mapped through the upscaling.
    for j, key in SLOT_KEYS.items():
        edge = _upscaled(key)
        b = p[f"dec.hyper.{j}.b2"]
        b[0] = SLOPE
        b[1] = -SLOPE * edge / one

    # IoU head: z_j from the hash, in units of its spread.
    n_mask = p["dec.iou_head.b2"].shape[0]
    phase = 2.0 * math.pi * torch.rand((n_mask, HASH_FREQS),
                                       generator=generator, device=dev)
    # The IoU token's hash channels after the first layer's LayerNorm:
    # half the point's encoding, scaled to the LayerNorm's norm.
    amp = math.sqrt(dim) / math.sqrt(HASH_FREQS)
    unit = 1.0 / (amp * math.sqrt(HASH_FREQS / 2.0))
    tau = statistics.NormalDist().inv_cdf(PASS_SHARE)
    for j in range(n_mask):
        p["dec.iou_head.w0"][HASH[:HASH_FREQS], j] = \
            unit * torch.cos(phase[j])
        p["dec.iou_head.w0"][HASH[HASH_FREQS:], j] = \
            unit * torch.sin(phase[j])
        p["dec.iou_head.b0"][j] = 10.0
        p["dec.iou_head.w1"][j, j] = 1.0
        p["dec.iou_head.w2"][j, j] = -IOU_SLOPE
        p["dec.iou_head.b2"][j] = 0.88 + IOU_SLOPE * (10.0 + tau)


def _upscaled(key: float) -> float:
    """The upscaling's blob channel (``x[0]``) at a key value ``key``:
    the first transposed convolution gives channels ``key`` and 16, the
    channel LayerNorm over 64 of them, GELU, then GELU again."""
    z = torch.zeros(64)
    z[0], z[1] = key, 16.0
    y = torch.nn.functional.layer_norm(z, (64,), eps=1e-6)
    return torch.nn.functional.gelu(torch.nn.functional.gelu(y[0])).item()

"""Wrapper of the fused SAM mask upscaling kernel (``csrc/sam_upscale.cu``).

It computes what ``features/sam.py::upscale_masks_plain`` computes (both
2x2 stride-2 transposed convolutions, the channel LayerNorm, both GELUs and
the hypernetwork mask product) in one launch per prompt batch; the JAX
package has no Pallas kernel there (XLA runs its transposed convolutions).
``features/sam.py::upscale_masks`` takes the plain chain for CPU tensors and
this wrapper for CUDA ones, which runs the kernel or raises.  Forward
only: the decoder runs under ``no_grad``.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import profiling
from . import build
from .build import check_tensor

# SAM's decoder widths, the same in every released model: the image
# features, the two upscalings' channels; the mask slots at most.
WIDTH, UP1, UP2, SLOTS = 256, 64, 32, 4
GRID = 64            # the image features' side

_P = ctypes.c_void_p
_I = ctypes.c_int


# The last weights reshaped for the kernel: (up1.w, its version, up2.w, its
# version, W1', W2'), so that a model's prompt batches reshape them once.
_reshaped = None


def _weights(params):
    """The kernel's weights: up1.w as [256, (dy, dx, 64)] and up2.w as
    [64, (dy2, dx2, 32)] (stored as the forward convolution's [kh, kw, out,
    in]), and the vectors, each checked."""
    global _reshaped
    shapes = {"dec.up1.w": (2, 2, UP1, WIDTH), "dec.up1.b": (UP1,),
              "dec.up_ln.scale": (UP1,), "dec.up_ln.bias": (UP1,),
              "dec.up2.w": (2, 2, UP2, UP1), "dec.up2.b": (UP2,)}
    for name, shape in shapes.items():
        w = params[name]
        if w.requires_grad:
            raise ValueError(f"sam_upscale: {name} requires grad; the "
                             "kernel is forward only")
        if w.dtype != torch.float32 or tuple(w.shape) != shape:
            raise ValueError(f"sam_upscale: {name} must be float32 "
                             f"{list(shape)}, got {w.dtype} "
                             f"{list(w.shape)}")
    u1, u2 = params["dec.up1.w"], params["dec.up2.w"]
    if _reshaped is None or _reshaped[0] is not u1 or _reshaped[2] is not u2 \
            or _reshaped[1] != u1._version or _reshaped[3] != u2._version:
        _reshaped = (
            u1, u1._version, u2, u2._version,
            u1.permute(3, 0, 1, 2).reshape(WIDTH, 4 * UP1).contiguous(),
            u2.permute(3, 0, 1, 2).reshape(UP1, 4 * UP2).contiguous())
    w1, w2 = _reshaped[4:]
    return [w1, *(params[name].contiguous() for name in (
        "dec.up1.b", "dec.up_ln.scale", "dec.up_ln.bias")),
            w2, params["dec.up2.b"].contiguous()]


def upscale_masks(params, im: torch.Tensor,
                  hyper: torch.Tensor) -> torch.Tensor:
    """The mask decoder's image features ``im`` [B, 4096, 256] (channel
    last, contiguous) and hypernetwork outputs ``hyper`` [B, M, 32] (M at
    most 4) -> mask logits [B, M, 256, 256], by the kernel.  Raises unless
    every tensor is float32 at SAM's decoder widths on one CUDA device and
    none requires grad.  Counts B as ``sam.fused_up``."""
    if im.requires_grad or hyper.requires_grad:
        raise ValueError("sam_upscale: an input requires grad; the kernel "
                         "is forward only")
    if im.dtype != torch.float32 or hyper.dtype != torch.float32:
        raise ValueError(f"sam_upscale: im and hyper must be float32, got "
                         f"{im.dtype} and {hyper.dtype}")
    b = im.shape[0]
    if im.dim() != 3 or tuple(im.shape[1:]) != (GRID * GRID, WIDTH) \
            or hyper.dim() != 3 or hyper.shape[0] != b \
            or not 1 <= hyper.shape[1] <= SLOTS or hyper.shape[2] != UP2:
        raise ValueError(f"sam_upscale: im must be [B, {GRID * GRID}, "
                         f"{WIDTH}] and hyper [B, 1..{SLOTS}, {UP2}], got "
                         f"{list(im.shape)} and {list(hyper.shape)}")
    weights = _weights(params)
    if not im.is_contiguous() or not hyper.is_contiguous():
        raise ValueError("sam_upscale: im and hyper must be contiguous")
    dev = im.device
    if dev.type != "cuda":
        raise ValueError(f"sam_upscale: the kernel runs on a CUDA device, "
                         f"not {dev}")
    check_tensor("sam_upscale: hyper", hyper, tuple(hyper.shape),
                 torch.float32, dev)
    for w in weights:
        check_tensor("sam_upscale: a weight", w, tuple(w.shape),
                     torch.float32, dev)
    slots = hyper.shape[1]
    masks = torch.empty((b, slots, 4 * GRID, 4 * GRID), dtype=torch.float32,
                        device=dev)
    if b == 0:
        return masks
    fn = build.entry("sam_upscale", "sam_upscale", *[_P] * 8, _I, _I, _P)
    build.launch("sam_upscale", fn, dev, im.data_ptr(),
                 *(w.data_ptr() for w in weights), hyper.data_ptr(), b,
                 slots, masks.data_ptr())
    profiling.count("sam.fused_up", b)
    return masks

"""Wrapper of the batched compositing kernel (``csrc/batched_fwd.cu``).

Replaces the JAX package's Pallas ``ops/pallas/batched.py::
composite_batched_fwd``, which computes the forward of the XLA fused
compositor.  For CPU tensors it runs the plain version
(``core/compositing.py::fused_forward``); for CUDA tensors it launches the
kernel or raises.  The kernel's backward (and the ``blk_cum`` residual the
TPU kernel banks for it) comes with the training slice; until then
:func:`composite` refuses to differentiate.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.compositing import G_VALS, fused_forward
from . import build

launches = 0   # kernel launches since the caller last reset it

KERNEL_VALUE_CHANNELS = (6, 19)   # normal ++ RGB, normal ++ RGB ++ 13 latents
KERNEL_TILE_SIZE = 16

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _fn():
    fn = build.load("batched_fwd").composite_batched_fwd
    fn.argtypes = [_P, _P, _I, _I, _I, _I, ctypes.c_float, _P, _P, _P, _P,
                   _P, _P]
    fn.restype = _I
    return fn


def composite_batched_fwd(g: torch.Tensor, mask: torch.Tensor, ntx: int,
                          ts: int, near_plane: float):
    """Composite every tile's window (see ``fused_forward`` for the
    contract): g [T, K, 9 + V] and mask [T, K] float32 -> (out_v [T, P, V],
    alpha, depth_acc, median [T, P] float32, med_idx [T, P] int32)."""
    if g.device.type == "cpu":
        return fused_forward(g, mask, ntx, ts, near_plane)
    if g.device.type != "cuda":
        raise ValueError(f"composite_batched_fwd: unsupported device "
                         f"{g.device}")
    if g.dim() != 3 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("composite_batched_fwd: g must be contiguous "
                         "float32 [T, K, 9 + V]")
    t, k, d = g.shape
    v = d - G_VALS
    if v not in KERNEL_VALUE_CHANNELS:
        raise ValueError(f"composite_batched_fwd: V={v} value channels; the "
                         f"kernel is built for {KERNEL_VALUE_CHANNELS}")
    if ts != KERNEL_TILE_SIZE:
        raise ValueError(f"composite_batched_fwd: tile size {ts}; the kernel "
                         f"runs {KERNEL_TILE_SIZE}x{KERNEL_TILE_SIZE} tiles")
    if mask.shape != (t, k) or mask.dtype != torch.float32 \
            or mask.device != g.device or not mask.is_contiguous():
        raise ValueError(f"composite_batched_fwd: mask must be contiguous "
                         f"float32 [{t}, {k}] on {g.device}")
    p = ts * ts
    out_v = torch.empty((t, p, v), dtype=torch.float32, device=g.device)
    alpha, depth, median = (
        torch.empty((t, p), dtype=torch.float32, device=g.device)
        for _ in range(3))
    idx = torch.empty((t, p), dtype=torch.int32, device=g.device)
    if t == 0:
        return out_v, alpha, depth, median, idx
    with torch.cuda.device(g.device):
        rc = _fn()(g.data_ptr(), mask.data_ptr(), t, k, v, ntx, near_plane,
                   out_v.data_ptr(), alpha.data_ptr(), depth.data_ptr(),
                   median.data_ptr(), idx.data_ptr(),
                   build.stream_handle(g.device))
    build.check(rc, "composite_batched_fwd")
    global launches
    launches += 1
    return out_v, alpha, depth, median, idx


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, mask, ntx, ts, near_plane):
        out = composite_batched_fwd(g, mask, ntx, ts, near_plane)
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the compositing backward kernel is not ported yet; no gradient "
            "flows through the compositor")


def composite(g: torch.Tensor, mask: torch.Tensor, ntx: int, ts: int,
              near_plane: float):
    """:func:`composite_batched_fwd` under autograd; its backward raises."""
    return _Composite.apply(g, mask, ntx, ts, near_plane)

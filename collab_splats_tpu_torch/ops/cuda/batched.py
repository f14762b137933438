"""Wrappers of the batched compositing kernels (``csrc/batched_fwd.cu`` and
``csrc/batched_bwd.cu``) and the autograd function that pairs them.

Replace the JAX package's Pallas ``ops/pallas/batched.py::
composite_batched_fwd`` and ``ops/pallas/batched_bwd.py::
composite_batched_bwd``, which compute the forward and the backward of the
XLA fused compositor.  For CPU tensors each wrapper runs its plain version
(``core/compositing.py::fused_forward`` / ``fused_backward``); for CUDA
tensors it runs its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.compositing import (G_VALS, PREFIX_BATCH, fused_backward,
                                 fused_forward)
from . import build
from .build import KERNEL_TILE_SIZE, check_tensor

KERNEL_VALUE_CHANNELS = (6, 19)   # normal ++ RGB, normal ++ RGB ++ 13 latents

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _check_rows(name, g, mask, ts):
    """(T, K, V) of the window rows g [T, K, 9 + V] and mask [T, K]."""
    if g.dim() != 3 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"{name}: g must be contiguous float32 "
                         "[T, K, 9 + V]")
    t, k, d = g.shape
    v = d - G_VALS
    if v not in KERNEL_VALUE_CHANNELS:
        raise ValueError(f"{name}: V={v} value channels; the kernel is built "
                         f"for {KERNEL_VALUE_CHANNELS}")
    if ts != KERNEL_TILE_SIZE:
        raise ValueError(f"{name}: tile size {ts}; the kernel runs "
                         f"{KERNEL_TILE_SIZE}x{KERNEL_TILE_SIZE} tiles")
    check_tensor(f"{name}: mask", mask, (t, k), torch.float32, g.device)
    return t, k, v


def composite_batched_fwd(g: torch.Tensor, mask: torch.Tensor, ntx: int,
                          ts: int, near_plane: float,
                          bank_prefix: bool = False):
    """Composite every tile's window (see ``fused_forward`` for the
    contract): g [T, K, 9 + V] and mask [T, K] float32 -> (out_v [T, P, V],
    alpha, depth_acc, median [T, P] float32, med_idx [T, P] int32), and
    with ``bank_prefix`` the backward's residual prefix [K/64, T, P]."""
    if g.device.type == "cpu":
        return fused_forward(g, mask, ntx, ts, near_plane,
                             bank_prefix=bank_prefix)
    if g.device.type != "cuda":
        raise ValueError(f"composite_batched_fwd: unsupported device "
                         f"{g.device}")
    t, k, v = _check_rows("composite_batched_fwd", g, mask, ts)
    p = ts * ts
    out_v = torch.empty((t, p, v), dtype=torch.float32, device=g.device)
    alpha, depth, median = (
        torch.empty((t, p), dtype=torch.float32, device=g.device)
        for _ in range(3))
    idx = torch.empty((t, p), dtype=torch.int32, device=g.device)
    outs = (out_v, alpha, depth, median, idx)
    prefix = None
    if bank_prefix:
        prefix = torch.empty((-(-k // PREFIX_BATCH), t, p),
                             dtype=torch.float32, device=g.device)
        outs += (prefix,)
    if t == 0:
        return outs
    fn = build.entry("batched_fwd", "composite_batched_fwd", _P, _P, _I, _I,
                     _I, _I, _F, *[_P] * 6)
    build.launch("composite_batched_fwd", fn, g.device, g.data_ptr(),
                 mask.data_ptr(), t, k, v, ntx, near_plane, out_v.data_ptr(),
                 alpha.data_ptr(), depth.data_ptr(), median.data_ptr(),
                 idx.data_ptr(),
                 None if prefix is None else prefix.data_ptr())
    return outs


def composite_batched_bwd(g: torch.Tensor, mask: torch.Tensor,
                          prefix: torch.Tensor, g_v: torch.Tensor,
                          g_alpha: torch.Tensor, g_depth: torch.Tensor,
                          g_med: torch.Tensor, idx: torch.Tensor,
                          t_total: torch.Tensor, ntx: int, ts: int,
                          near_plane: float) -> torch.Tensor:
    """Backward of :func:`composite_batched_fwd` (see ``fused_backward``
    for the contract): the forward's g, mask, banked prefix and median slot
    ``idx``, the transmittance ``t_total`` = 1 - alpha, and the cotangents
    of out_v [T, P, V], alpha, depth_acc and median [T, P] -> d_g
    [T, K, 9 + V], exactly 0 at masked and dead slots."""
    if g.device.type == "cpu":
        return fused_backward(g, mask, idx, t_total, g_v, g_alpha, g_depth,
                              g_med, ntx, ts, near_plane)
    if g.device.type != "cuda":
        raise ValueError(f"composite_batched_bwd: unsupported device "
                         f"{g.device}")
    t, k, v = _check_rows("composite_batched_bwd", g, mask, ts)
    p = ts * ts
    dev = g.device
    check_tensor("composite_batched_bwd: prefix", prefix,
                 (-(-k // PREFIX_BATCH), t, p), torch.float32, dev)
    check_tensor("composite_batched_bwd: g_v", g_v, (t, p, v), torch.float32,
                 dev)
    for name, x in (("g_alpha", g_alpha), ("g_depth", g_depth),
                    ("g_med", g_med), ("t_total", t_total)):
        check_tensor(f"composite_batched_bwd: {name}", x, (t, p),
                     torch.float32, dev)
    check_tensor("composite_batched_bwd: idx", idx, (t, p), torch.int32, dev)
    d_g = torch.empty_like(g)
    if t == 0:
        return d_g
    fn = build.entry("batched_bwd", "composite_batched_bwd", *[_P] * 9, _I,
                     _I, _I, _I, _F, _P)
    build.launch("composite_batched_bwd", fn, dev, g.data_ptr(),
                 mask.data_ptr(), prefix.data_ptr(), g_v.data_ptr(),
                 g_alpha.data_ptr(), g_depth.data_ptr(), g_med.data_ptr(),
                 idx.data_ptr(), t_total.data_ptr(), t, k, v, ntx,
                 near_plane, d_g.data_ptr())
    return d_g


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, mask, ntx, ts, near_plane):
        # Bank the backward's residual only when a backward will follow.
        bank = ctx.needs_input_grad[0]
        out = composite_batched_fwd(g, mask, ntx, ts, near_plane,
                                    bank_prefix=bank)
        ctx.mark_non_differentiable(out[4])
        if bank:
            ctx.save_for_backward(g, mask, out[1], out[4], out[5])
            ctx.args = (ntx, ts, near_plane)
        return out[:5]

    @staticmethod
    def backward(ctx, g_v, g_alpha, g_depth, g_med, _):
        g, mask, alpha, idx, prefix = ctx.saved_tensors
        t, p = alpha.shape

        # An output the loss does not reach has no cotangent; slices of the
        # stitched maps arrive as strided views.
        def cot(c, *shape):
            if c is None:
                return torch.zeros(shape, dtype=g.dtype, device=g.device)
            return c.contiguous()

        d_g = composite_batched_bwd(
            g, mask, prefix, cot(g_v, t, p, g.shape[2] - G_VALS),
            cot(g_alpha, t, p), cot(g_depth, t, p), cot(g_med, t, p), idx,
            1.0 - alpha, *ctx.args)
        return d_g, None, None, None, None


def composite(g: torch.Tensor, mask: torch.Tensor, ntx: int, ts: int,
              near_plane: float):
    """:func:`composite_batched_fwd` under autograd, with
    :func:`composite_batched_bwd` as its backward (gradients reach g)."""
    return _Composite.apply(g, mask, ntx, ts, near_plane)

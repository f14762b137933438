"""Wrappers of the SH colour kernels (``csrc/sh_colors.cu``) and the
autograd function that pairs them.

They replace the plain autograd chain of ``core/sh.py::eval_sh_colors``
(the coefficients' ``cat``, the basis and its degree mask, the einsum, the
shift and the clamp) on the colours' path; the JAX package has no Pallas
kernel there (XLA fuses ``eval_sh``).  For CPU tensors the forward runs
``eval_sh_colors`` and the backward ``eval_sh_colors_backward``; for CUDA
tensors each runs its kernel or raises.  Gradients reach features_dc,
features_rest and means, and the camera centre where it requires grad
(pose optimisation) as minus the sum of the means' gradients.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.sh import eval_sh_colors, eval_sh_colors_backward, num_sh_bases
from ...utils import profiling
from . import build
from .build import check_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# The bases a row the kernels are built for: SH degrees 1, 2 and 3.
KERNEL_BASES = (4, 9, 16)


def _check(dc, rest, means, center):
    """(rows, bases a row, device) of the kernels' inputs; raises on what
    they do not take."""
    n, dev = means.shape[0], means.device
    k = rest.shape[1] + 1 if rest.dim() == 3 else 0
    if k not in KERNEL_BASES:
        raise ValueError(f"sh_colors: features_rest must be [N, K-1, 3] "
                         f"with K in {KERNEL_BASES}, got {list(rest.shape)}")
    check_tensor("sh_colors: features_dc", dc, (n, 3), torch.float32, dev)
    check_tensor("sh_colors: features_rest", rest, (n, k - 1, 3),
                 torch.float32, dev)
    check_tensor("sh_colors: means", means, (n, 3), torch.float32, dev)
    if center.shape != (3,) or center.dtype != torch.float32 \
            or center.device != dev:
        raise ValueError(f"sh_colors: center must be float32 [3] on {dev}, "
                         f"got {center.dtype} {list(center.shape)} on "
                         f"{center.device}")
    if rest.data_ptr() % 16:
        raise ValueError("sh_colors: features_rest must be 16-byte aligned")
    return n, k, dev


def _aligned(x):
    """``x`` contiguous, copied where the kernels' 16-byte loads could not
    read it in place (a view whose first row is not 16-byte aligned, such
    as ``parallel/mesh.py::shard``'s block of a table)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _active(k, active_degree):
    return min(num_sh_bases(int(active_degree)), k)


def sh_fwd(features_dc, features_rest, means, center,
           active_degree: int) -> torch.Tensor:
    """``eval_sh_colors`` without its autograd graph: the forward kernel on
    the card, the plain version on the CPU.  Counts the rows the kernel
    runs over as ``render.sh_fused_rows`` (0 on the CPU)."""
    if means.device.type == "cpu":
        profiling.count("render.sh_fused_rows", 0)
        return eval_sh_colors(features_dc, features_rest, means, center,
                              active_degree)
    if means.device.type != "cuda":
        raise ValueError(f"sh_colors: unsupported device {means.device}")
    n, k, dev = _check(features_dc, features_rest, means, center)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        fn = build.entry("sh_colors", "sh_fwd", *[_P] * 4, _I, _I, _I, _I,
                         _P)
        build.launch("sh_fwd", fn, dev, features_dc.data_ptr(),
                     features_rest.data_ptr(), means.data_ptr(),
                     center.data_ptr(), center.stride(0), n, k,
                     _active(k, active_degree), out.data_ptr())
    profiling.count("render.sh_fused_rows", n)
    return out


def sh_bwd(features_dc, features_rest, means, center, active_degree: int,
           grad, want=(True, True, True)):
    """The gradients (features_dc, features_rest, means) of
    :func:`sh_fwd` for the colours' cotangent ``grad`` [N, 3], each only
    where ``want`` asks for it and None otherwise.  The backward kernel on
    the card, ``eval_sh_colors_backward`` on the CPU."""
    if means.device.type == "cpu":
        got = eval_sh_colors_backward(features_dc, features_rest, means,
                                      center, active_degree, grad)
        return tuple(g if w else None for g, w in zip(got, want))
    if means.device.type != "cuda":
        raise ValueError(f"sh_colors: unsupported device {means.device}")
    n, k, dev = _check(features_dc, features_rest, means, center)
    if grad.shape != (n, 3) or grad.dtype != torch.float32 \
            or grad.device != dev:
        raise ValueError(f"sh_colors: the cotangent must be float32 [{n}, 3] "
                         f"on {dev}, got {grad.dtype} {list(grad.shape)} on "
                         f"{grad.device}")
    if grad.stride(1) != 1:
        grad = grad.contiguous()
    outs = tuple(torch.empty_like(x) if w else None for x, w in
                 zip((features_dc, features_rest, means), want))
    if n and any(want):
        fn = build.entry("sh_colors", "sh_bwd", *[_P] * 4, _I, _I, _I, _I,
                         _P, _L, _P, _P, _P)
        build.launch("sh_bwd", fn, dev, features_dc.data_ptr(),
                     features_rest.data_ptr(), means.data_ptr(),
                     center.data_ptr(), center.stride(0), n, k,
                     _active(k, active_degree), grad.data_ptr(),
                     grad.stride(0),
                     *(None if g is None else g.data_ptr() for g in outs))
    return outs


class _ShColors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features_dc, features_rest, means, center,
                active_degree):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(features_dc, features_rest, means, center)
        ctx.active_degree = active_degree
        return sh_fwd(features_dc, features_rest, means, center,
                      active_degree)

    @staticmethod
    def backward(ctx, grad):
        want_dc, want_rest, want_means, want_center = ctx.needs_input_grad[:4]
        if grad is None:
            return (None,) * 5
        dc, rest, means, center = ctx.saved_tensors
        g_dc, g_rest, g_means = sh_bwd(
            dc, rest, means, center, ctx.active_degree, grad,
            (want_dc, want_rest, want_means or want_center))
        g_center = -g_means.sum(0) if want_center else None
        return (g_dc, g_rest, g_means if want_means else None, g_center,
                None)


def sh_colors(features_dc: torch.Tensor, features_rest: torch.Tensor,
              means: torch.Tensor, center: torch.Tensor,
              active_degree: int) -> torch.Tensor:
    """``eval_sh_colors`` (same arguments, colours [N, 3]) under autograd,
    with the kernels on the card and their plain versions on the CPU;
    gradients reach features_dc, features_rest and means, and ``center``
    where it requires grad."""
    return _ShColors.apply(features_dc.contiguous(), _aligned(features_rest),
                           means.contiguous(), center, int(active_degree))

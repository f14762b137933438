"""Wrappers of the fused projection kernels (``csrc/projection.cu``) and the
autograd function that pairs them.

They replace the plain autograd chain of ``core/projection.py::
project_gaussians`` on the render's path; the JAX package has no Pallas
kernel there (XLA fuses the projection).  For CPU tensors the forward runs
``project_gaussians`` and the backward ``project_backward``; for CUDA
tensors each runs its kernel or raises.  Gradients reach means, quats
and scales, and ``viewmat`` and ``K`` where they require grad (pose
optimisation).
"""

from __future__ import annotations

import ctypes

import torch

from ...core.projection import Projection, project_backward, project_gaussians
from ...utils import profiling
from . import build
from .build import check_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _camera(viewmat, K, dev):
    viewmat = viewmat.detach().contiguous()
    K = K.detach().contiguous()
    check_tensor("project: viewmat", viewmat, (4, 4), torch.float32, dev)
    check_tensor("project: K", K, (3, 3), torch.float32, dev)
    return viewmat, K


def _check_rows(means, quats, scales):
    n = means.shape[0]
    dev = means.device
    check_tensor("project: means", means, (n, 3), torch.float32, dev)
    check_tensor("project: quats", quats, (n, 4), torch.float32, dev)
    check_tensor("project: scales", scales, (n, 3), torch.float32, dev)
    return n, dev


def project_fwd(means, quats, scales, viewmat, K, width, height, eps2d,
                near_plane, far_plane, radius_clip, opacities) -> Projection:
    """``project_gaussians`` without its autograd graph: the forward
    kernel on the card, the plain version on the CPU.  Counts the rows the
    kernel runs over as ``render.fused_rows`` (0 on the CPU)."""
    if means.device.type == "cpu":
        profiling.count("render.fused_rows", 0)
        return project_gaussians(
            means, quats, scales, viewmat, K, width, height, eps2d=eps2d,
            near_plane=near_plane, far_plane=far_plane,
            radius_clip=radius_clip, opacities=opacities)
    if means.device.type != "cuda":
        raise ValueError(f"project: unsupported device {means.device}")
    n, dev = _check_rows(means, quats, scales)
    viewmat, K = _camera(viewmat, K, dev)
    if opacities is not None:
        opacities = opacities.detach()
        check_tensor("project: opacities", opacities, (n,), torch.float32,
                     dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty((n,) + shape, dtype=dtype, device=dev)

    out = Projection(mean2d=empty(2), depth=empty(), conic=empty(3),
                     radius=empty(), compensation=empty(), plane=empty(2),
                     normal=empty(3), valid=empty(dtype=torch.bool),
                     radius_xy=empty(2))
    if n == 0:
        return out
    fn = build.entry("projection", "project_fwd", *[_P] * 6, _I, _I, _I, _F,
                     _F, _F, _F, *[_P] * 9)
    build.launch(
        "project_fwd", fn, dev, means.data_ptr(), quats.data_ptr(),
        scales.data_ptr(),
        None if opacities is None else opacities.data_ptr(),
        viewmat.data_ptr(), K.data_ptr(), n, width, height, eps2d,
        near_plane, far_plane, radius_clip, *(x.data_ptr() for x in out))
    profiling.count("render.fused_rows", n)
    return out


# The differentiable outputs, in the kernel's cotangent order, and each
# one's row width (0 for [N]).
_COTANGENTS = (("mean2d", 2), ("depth", 0), ("conic", 3), ("plane", 2),
               ("normal", 3), ("compensation", 0))


def _cotangent(name, g, n, width, dev):
    """``g`` as the kernel reads it: float32 on ``dev`` with contiguous
    columns; (pointer or None, row stride)."""
    if g is None:
        return None, 0
    shape = (n, width) if width else (n,)
    if g.shape != shape or g.dtype != torch.float32 or g.device != dev:
        raise ValueError(f"project_bwd: {name} cotangent must be float32 "
                         f"{list(shape)} on {dev}, got {g.dtype} "
                         f"{list(g.shape)} on {g.device}")
    if width and g.stride(1) != 1:
        g = g.contiguous()
    return g, g.stride(0)


def project_bwd(means, quats, scales, viewmat, K, eps2d, near_plane,
                far_plane, *cotangents, camera=False):
    """The gradient of :func:`project_fwd`, given the cotangents of
    mean2d, depth, conic, plane, normal and compensation (None where an
    output takes none): (v_means, v_quats, v_scales, v_viewmat, v_K), the
    last two only with ``camera`` and None otherwise.  The backward kernel
    on the card, ``project_backward`` on the CPU."""
    if means.device.type == "cpu":
        return project_backward(means, quats, scales, viewmat, K, eps2d,
                                near_plane, far_plane, *cotangents,
                                camera=camera)
    if means.device.type != "cuda":
        raise ValueError(f"project_bwd: unsupported device {means.device}")
    n, dev = _check_rows(means, quats, scales)
    viewmat, K = _camera(viewmat, K, dev)
    held = [_cotangent(name, g, n, width, dev)
            for (name, width), g in zip(_COTANGENTS, cotangents)]
    v_means, v_quats, v_scales = (torch.empty_like(x)
                                  for x in (means, quats, scales))
    v_viewmat = v_K = partials = None
    if camera:
        v_viewmat, v_K = torch.zeros_like(viewmat), torch.zeros_like(K)
        # 16 floats for each block of the kernel's 256 rows.
        partials = torch.empty(16 * ((n + 255) // 256), dtype=torch.float32,
                               device=dev)
    if n == 0:
        return v_means, v_quats, v_scales, v_viewmat, v_K
    ptrs = (_P * 6)(*(None if g is None else g.data_ptr() for g, _ in held))
    strides = (ctypes.c_longlong * 6)(*(s for _, s in held))
    fn = build.entry("projection", "project_bwd", *[_P] * 5, _I, _F, _F, _F,
                     *[_P] * 8)
    build.launch(
        "project_bwd", fn, dev, means.data_ptr(), quats.data_ptr(),
        scales.data_ptr(), viewmat.data_ptr(), K.data_ptr(), n, eps2d,
        near_plane, far_plane, ptrs, strides, v_means.data_ptr(),
        v_quats.data_ptr(), v_scales.data_ptr(),
        *(None if x is None else x.data_ptr()
          for x in (partials, v_viewmat, v_K)))
    return v_means, v_quats, v_scales, v_viewmat, v_K


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means, quats, scales, opacities, viewmat, K, width,
                height, eps2d, near_plane, far_plane, radius_clip):
        out = project_fwd(means, quats, scales, viewmat, K, width, height,
                          eps2d, near_plane, far_plane, radius_clip,
                          opacities)
        ctx.mark_non_differentiable(out.radius, out.valid, out.radius_xy)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means, quats, scales, viewmat, K)
        ctx.args = (eps2d, near_plane, far_plane)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_mean2d, g_depth, g_conic, _radius, g_comp, g_plane,
                 g_normal, _valid, _radius_xy):
        means, quats, scales, viewmat, K = ctx.saved_tensors
        want_vm, want_k = ctx.needs_input_grad[4:6]
        v_means, v_quats, v_scales, v_viewmat, v_K = project_bwd(
            means, quats, scales, viewmat, K, *ctx.args, g_mean2d, g_depth,
            g_conic, g_plane, g_normal, g_comp, camera=want_vm or want_k)
        return (v_means, v_quats, v_scales, None,
                v_viewmat if want_vm else None,
                v_K if want_k else None) + (None,) * 6


def project(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
            viewmat: torch.Tensor, K: torch.Tensor, width: int, height: int,
            eps2d: float = 0.3, near_plane: float = 0.01,
            far_plane: float = 1e10, radius_clip: float = 0.0,
            opacities: torch.Tensor | None = None) -> Projection:
    """``project_gaussians`` (same arguments, same :class:`Projection`)
    under autograd, with the kernels on the card and their plain versions
    on the CPU; gradients reach means, quats and scales, and viewmat and
    K where they require grad."""
    if opacities is not None:
        opacities = opacities.contiguous()
    return Projection(*_Project.apply(
        means.contiguous(), quats.contiguous(), scales.contiguous(),
        opacities, viewmat, K, width, height, eps2d, near_plane, far_plane,
        radius_clip))

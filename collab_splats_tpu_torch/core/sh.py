"""Real spherical harmonics (degrees 0-3) for Gaussian-splat colours.

Counterpart of the JAX package's ``core/sh.py``, with the same constants.
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_basis(dirs: torch.Tensor, num_bases: int) -> torch.Tensor:
    """SH basis values [..., num_bases] of unit directions [..., 3]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    basis = [torch.full_like(x, _C0)]
    if num_bases > 1:
        basis += [-_C1 * y, _C1 * z, -_C1 * x]
    if num_bases > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if num_bases > 9:
        xx, yy, zz = x * x, y * y, z * z
        basis += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * x * y * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(basis, dim=-1)


def degree_mask(num_bases: int, active_degree: int,
                device=None) -> torch.Tensor:
    """[num_bases] 0/1 float mask enabling bases of degree <= active_degree
    (the degree of basis b is floor(sqrt(b)), so the first (d + 1)^2
    bases).  Made on ``device``, with no copy from the host."""
    bases = torch.arange(num_bases, device=device)
    return (bases < (int(active_degree) + 1) ** 2).to(torch.float32)


def eval_sh(coeffs: torch.Tensor, dirs: torch.Tensor,
            active_degree: int) -> torch.Tensor:
    """Raw SH colours [N, 3] from coefficients [N, K, 3] and (not
    necessarily unit) directions [N, 3]; no +0.5 shift and no clamp."""
    num_bases = coeffs.shape[-2]
    norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-12)
    basis = eval_sh_basis(dirs / norm, num_bases)
    mask = degree_mask(num_bases, active_degree, device=coeffs.device)
    return torch.einsum("nk,nkc->nc", basis * mask[None, :], coeffs)


def eval_sh_colors(features_dc: torch.Tensor, features_rest: torch.Tensor,
                   means: torch.Tensor, center: torch.Tensor,
                   active_degree: int) -> torch.Tensor:
    """Splat colours [N, 3] seen from ``center`` [3]: the SH of
    ``cat(features_dc [N, 3], features_rest [N, K-1, 3])`` in the
    directions ``means - center``, +0.5 and clamped at 0."""
    coeffs = torch.cat([features_dc[:, None, :], features_rest], dim=1)
    rgb = eval_sh(coeffs, means - center[None, :], active_degree)
    return torch.clamp(rgb + 0.5, min=0.0)


def _basis_backward(u: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """The gradient [N, 3] at unit directions ``u`` of the bases'
    gradients ``gb`` [N, K], band by band."""
    x, y, z = u[:, 0], u[:, 1], u[:, 2]
    num_bases = gb.shape[1]
    g = [torch.zeros_like(x) for _ in range(3)]
    if num_bases > 1:
        g[0] = g[0] - _C1 * gb[:, 3]
        g[1] = g[1] - _C1 * gb[:, 1]
        g[2] = g[2] + _C1 * gb[:, 2]
    if num_bases > 4:
        b = gb[:, 4:9]
        g[0] = g[0] + (_C2[0] * y * b[:, 0] - 2.0 * _C2[2] * x * b[:, 2]
                       + _C2[3] * z * b[:, 3] + 2.0 * _C2[4] * x * b[:, 4])
        g[1] = g[1] + (_C2[0] * x * b[:, 0] + _C2[1] * z * b[:, 1]
                       - 2.0 * _C2[2] * y * b[:, 2]
                       - 2.0 * _C2[4] * y * b[:, 4])
        g[2] = g[2] + (_C2[1] * y * b[:, 1] + 4.0 * _C2[2] * z * b[:, 2]
                       + _C2[3] * x * b[:, 3])
    if num_bases > 9:
        b = gb[:, 9:16]
        xx, yy, zz = x * x, y * y, z * z
        g[0] = g[0] + (6.0 * _C3[0] * x * y * b[:, 0]
                       + _C3[1] * y * z * b[:, 1]
                       - 2.0 * _C3[2] * x * y * b[:, 2]
                       - 6.0 * _C3[3] * x * z * b[:, 3]
                       + _C3[4] * (4.0 * zz - 3.0 * xx - yy) * b[:, 4]
                       + 2.0 * _C3[5] * x * z * b[:, 5]
                       + _C3[6] * (3.0 * xx - 3.0 * yy) * b[:, 6])
        g[1] = g[1] + (_C3[0] * (3.0 * xx - 3.0 * yy) * b[:, 0]
                       + _C3[1] * x * z * b[:, 1]
                       + _C3[2] * (4.0 * zz - xx - 3.0 * yy) * b[:, 2]
                       - 6.0 * _C3[3] * y * z * b[:, 3]
                       - 2.0 * _C3[4] * x * y * b[:, 4]
                       - 2.0 * _C3[5] * y * z * b[:, 5]
                       - 6.0 * _C3[6] * x * y * b[:, 6])
        g[2] = g[2] + (_C3[1] * x * y * b[:, 1]
                       + 8.0 * _C3[2] * y * z * b[:, 2]
                       + _C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * b[:, 3]
                       + 8.0 * _C3[4] * x * z * b[:, 4]
                       + _C3[5] * (xx - yy) * b[:, 5])
    return torch.stack(g, dim=-1)


def eval_sh_colors_backward(features_dc: torch.Tensor,
                            features_rest: torch.Tensor, means: torch.Tensor,
                            center: torch.Tensor, active_degree: int,
                            grad: torch.Tensor):
    """The gradients (features_dc, features_rest, means) of
    :func:`eval_sh_colors` for the colours' cotangent ``grad`` [N, 3], by
    hand in ``csrc/sh_colors.cu``'s order: the clamp passes the gradient
    where the shifted colour is >= 0, bases above the active degree take
    exact zeros, and the direction's gradient goes through its
    normalisation.  The centre's gradient is minus the sum of the means'."""
    num_bases = features_rest.shape[1] + 1
    coeffs = torch.cat([features_dc[:, None, :], features_rest], dim=1)
    dirs = means - center[None, :]
    raw = eval_sh(coeffs, dirs, active_degree)
    zero = grad.new_zeros(())
    gr = torch.where(raw + 0.5 >= 0.0, grad, zero)
    norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-12)
    u = dirs / norm
    basis = eval_sh_basis(u, num_bases)
    live = degree_mask(num_bases, active_degree, device=basis.device) > 0
    g_coeffs = torch.where(live[None, :, None],
                           basis[:, :, None] * gr[:, None, :], zero)
    gb = torch.where(live[None, :], torch.sum(coeffs * gr[:, None, :], -1),
                     zero)
    gu = _basis_backward(u, gb)
    dot = torch.sum(gu * u, dim=-1, keepdim=True)
    return g_coeffs[:, 0], g_coeffs[:, 1:], (gu - u * dot) / norm


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC-term shift: colour = C0 * sh0 + 0.5."""
    return (rgb - 0.5) / _C0


def sh0_to_rgb(sh0: torch.Tensor) -> torch.Tensor:
    return sh0 * _C0 + 0.5

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
    (the degree of basis b is floor(sqrt(b)))."""
    degs = torch.tensor([int(b ** 0.5 + 1e-6) for b in range(num_bases)],
                        device=device)
    return (degs <= int(active_degree)).to(torch.float32)


def eval_sh(coeffs: torch.Tensor, dirs: torch.Tensor,
            active_degree: int) -> torch.Tensor:
    """Raw SH colours [N, 3] from coefficients [N, K, 3] and (not
    necessarily unit) directions [N, 3]; no +0.5 shift and no clamp."""
    num_bases = coeffs.shape[-2]
    norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-12)
    basis = eval_sh_basis(dirs / norm, num_bases)
    mask = degree_mask(num_bases, active_degree, device=coeffs.device)
    return torch.einsum("nk,nkc->nc", basis * mask[None, :], coeffs)


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC-term shift: colour = C0 * sh0 + 0.5."""
    return (rgb - 0.5) / _C0


def sh0_to_rgb(sh0: torch.Tensor) -> torch.Tensor:
    return sh0 * _C0 + 0.5

"""EWA projection of 3D Gaussians with RaDe-GS ray-plane depth and normals.

Counterpart of the JAX package's ``core/projection.py`` (see its module
docstring for the derivation): dense per-Gaussian math over [N, ...]
tensors.  Products run in full float32 (TF32 is off, see the package
``__init__``), where the JAX code pins ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Projection(NamedTuple):
    """Per-Gaussian projection results (all leading dim N)."""

    mean2d: torch.Tensor        # [N, 2] pixel coords of the projected center
    depth: torch.Tensor         # [N] camera-space z-depth of the center
    conic: torch.Tensor         # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor        # [N] screen-space bounding radius in pixels
    compensation: torch.Tensor  # [N] antialias opacity compensation factor
    plane: torch.Tensor         # [N, 2] RaDe depth-plane gradient
    normal: torch.Tensor        # [N, 3] camera-space unit normal
    valid: torch.Tensor         # [N] bool visibility mask
    radius_xy: torch.Tensor     # [N, 2] per-axis bbox half-extents


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """Normalize wxyz quaternions [N, 4] and convert to rotations [N, 3, 3]."""
    q = quats / torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True)
                           + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], -1),
            torch.stack([r10, r11, r12], -1),
            torch.stack([r20, r21, r22], -1),
        ],
        dim=-2,
    )


def covariance3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """3D covariance ``R diag(s^2) R^T`` from quaternions and linear scales."""
    M = quat_to_rotmat(quats) * scales[..., None, :]
    return M @ M.transpose(-1, -2)


def min_axis_normal(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """World-space unit normal: the rotated axis of the smallest scale."""
    R = quat_to_rotmat(quats)
    idx = torch.argmin(scales, dim=-1)
    n = torch.gather(R, 2, idx[:, None, None].expand(-1, 3, 1))[..., 0]
    return n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)


def project_gaussians(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    opacities: torch.Tensor | None = None,
) -> Projection:
    """Project N Gaussians into one camera.

    Args and semantics are those of the JAX ``project_gaussians``: means
    [N, 3], wxyz quats [N, 4], *linear* scales [N, 3], a COLMAP viewmat
    [4, 4], intrinsics [3, 3]; optional activated ``opacities`` [N] tighten
    the per-axis bbox ``radius_xy`` to the exact alpha >= 1/255 extent.

    Returns:
        A :class:`Projection`; rows with ``valid == False`` hold finite
        placeholders.
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R_wc = viewmat[:3, :3]
    t_wc = viewmat[:3, 3]

    p_cam = means @ R_wc.T + t_wc                              # [N, 3]
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    in_depth = (z > near_plane) & (z < far_plane)
    zs = torch.where(in_depth, z, torch.ones_like(z))

    cov_w = covariance3d(quats, scales)                        # [N, 3, 3]
    cov_c = torch.einsum("ij,njk,lk->nil", R_wc, cov_w, R_wc)

    rz = 1.0 / zs
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * x * rz2
    j11 = fy * rz
    j12 = -fy * y * rz2

    c00, c01, c02 = cov_c[..., 0, 0], cov_c[..., 0, 1], cov_c[..., 0, 2]
    c11, c12, c22 = cov_c[..., 1, 1], cov_c[..., 1, 2], cov_c[..., 2, 2]

    # Sigma2D = J Sigma_c J^T: rows of J @ Sigma_c first, then times J^T.
    ju0 = j00 * c00 + j02 * c02
    ju2 = j00 * c02 + j02 * c22
    jv0 = j11 * c01 + j12 * c02
    jv1 = j11 * c11 + j12 * c12
    jv2 = j11 * c12 + j12 * c22
    a_raw = ju0 * j00 + ju2 * j02
    b_raw = jv0 * j00 + jv2 * j02
    c_raw = jv1 * j11 + jv2 * j12

    det_raw = a_raw * c_raw - b_raw * b_raw
    a = a_raw + eps2d
    c = c_raw + eps2d
    b = b_raw
    det = a * c - b * b
    ok_det = det > 1e-12
    det_safe = torch.where(ok_det, det, torch.ones_like(det))

    # Antialias compensation sqrt(det_raw / det_blurred).  The double where
    # keeps the forward identical to sqrt(clip(x, 0)) and pins the gradient
    # to 0 at the clamp instead of inf * 0 = NaN for needle-thin splats.
    ratio = det_raw / det_safe
    ratio_pos = ratio > 1e-12
    compensation = torch.where(
        ratio_pos,
        torch.sqrt(torch.where(ratio_pos, ratio, torch.ones_like(ratio))),
        torch.zeros_like(ratio),
    )

    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mean2d = torch.stack([fx * x * rz + cx, fy * y * rz + cy], dim=-1)

    # Square radius from the larger eigenvalue of the blurred covariance.
    mid = 0.5 * (a + c)
    eig_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(eig_max, min=0.0)))
    # Per-axis bbox of the alpha >= 1/255 ellipse; opacity-aware when given
    # (alpha = o exp(-sigma) >= 1/255 iff sigma <= ln(255 o)).
    if opacities is None:
        cut = 3.3291  # sqrt(2 ln 255)
    else:
        cut = torch.sqrt(2.0 * torch.clamp(
            torch.log(255.0 * torch.clamp(opacities.detach(), 0.0, 1.0)),
            min=0.0,
        ))
    rx = torch.ceil(torch.minimum(
        cut * torch.sqrt(torch.clamp(a, min=0.0)), radius))
    ry = torch.ceil(torch.minimum(
        cut * torch.sqrt(torch.clamp(c, min=0.0)), radius))
    radius_xy = torch.stack([rx, ry], dim=-1)

    # RaDe depth plane: Sigma'_{uv,t} = J (Sigma_c e_z); plane = conic @ it.
    s_ut = j00 * c02 + j02 * c22
    s_vt = j11 * c12 + j12 * c22
    plane_u = conic[..., 0] * s_ut + conic[..., 1] * s_vt
    plane_v = conic[..., 1] * s_ut + conic[..., 2] * s_vt
    plane = torch.stack([plane_u, plane_v], dim=-1)

    # Camera-space normal of the depth-plane surface, facing the camera.
    nz = plane_u * (mean2d[..., 0] - cx) + plane_v * (mean2d[..., 1] - cy) + zs
    n = torch.stack([-plane_u * fx, -plane_v * fy, nz], dim=-1)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    facing = torch.sum(n * p_cam, dim=-1, keepdim=True)
    n = torch.where(facing > 0.0, -n, n)

    u0, v0 = mean2d[..., 0], mean2d[..., 1]
    on_screen = ((u0 + radius > 0) & (u0 - radius < width)
                 & (v0 + radius > 0) & (v0 - radius < height))
    valid = in_depth & ok_det & on_screen & (radius > radius_clip)

    radius = torch.where(valid, radius, torch.zeros_like(radius))
    radius_xy = torch.where(valid[:, None], radius_xy,
                            torch.zeros_like(radius_xy))
    return Projection(
        mean2d=mean2d,
        depth=z,
        conic=conic,
        radius=radius,
        compensation=compensation,
        plane=plane,
        normal=n,
        valid=valid,
        radius_xy=radius_xy,
    )

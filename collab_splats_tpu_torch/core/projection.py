"""EWA projection of 3D Gaussians with RaDe-GS ray-plane depth and normals.

Counterpart of the JAX package's ``core/projection.py`` (see its module
docstring for the derivation): dense per-Gaussian math over [N, ...]
tensors.  Products run in full float32 (TF32 is off, see the package
``__init__``), where the JAX code pins ``Precision.HIGHEST``.  These are
the plain versions of the fused projection kernels (``csrc/projection.cu``,
``ops/cuda/projection.py``): :func:`project_gaussians` of the forward and
:func:`project_backward`, its gradient written out by hand, of the
backward.
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


class _Terms(NamedTuple):
    """One camera's per-row intermediates of :func:`project_gaussians` that
    its outputs and :func:`project_backward` read (all leading dim N)."""

    p_cam: torch.Tensor        # [N, 3] camera-space centre
    in_depth: torch.Tensor     # near < z < far
    zs: torch.Tensor           # z, or 1 where not in_depth
    rz: torch.Tensor           # 1 / zs
    cov_c: torch.Tensor        # [N, 3, 3] camera-space covariance
    j: tuple                   # J's entries j00, j02, j11, j12
    ju: tuple                  # rows of J Sigma_c: ju0, ju2, jv0, jv1, jv2
    raw: tuple                 # a_raw, b_raw, c_raw before the blur
    a: torch.Tensor            # blurred 2D covariance a, b, c
    b: torch.Tensor
    c: torch.Tensor
    det: torch.Tensor
    ok_det: torch.Tensor
    det_safe: torch.Tensor
    ratio: torch.Tensor        # det_raw / det_safe
    ratio_pos: torch.Tensor
    compensation: torch.Tensor
    inv_det: torch.Tensor
    conic: torch.Tensor        # [N, 3]
    mean2d: torch.Tensor       # [N, 2]
    s_t: tuple                 # J Sigma_c e_z: s_ut, s_vt
    plane: torch.Tensor        # [N, 2]
    n_raw: torch.Tensor        # [N, 3] normal before normalising
    n_len: torch.Tensor        # [N, 1] its length (+ 1e-12 under the root)
    flip: torch.Tensor         # [N, 1] the normal turned to face the camera
    normal: torch.Tensor       # [N, 3]


def _terms(means, quats, scales, viewmat, K, eps2d, near_plane,
           far_plane) -> _Terms:
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

    # RaDe depth plane: Sigma'_{uv,t} = J (Sigma_c e_z); plane = conic @ it.
    s_ut = j00 * c02 + j02 * c22
    s_vt = j11 * c12 + j12 * c22
    plane_u = conic[..., 0] * s_ut + conic[..., 1] * s_vt
    plane_v = conic[..., 1] * s_ut + conic[..., 2] * s_vt
    plane = torch.stack([plane_u, plane_v], dim=-1)

    # Camera-space normal of the depth-plane surface, facing the camera.
    nz = plane_u * (mean2d[..., 0] - cx) + plane_v * (mean2d[..., 1] - cy) + zs
    n_raw = torch.stack([-plane_u * fx, -plane_v * fy, nz], dim=-1)
    n_len = torch.sqrt(torch.sum(n_raw * n_raw, dim=-1, keepdim=True) + 1e-12)
    n = n_raw / n_len
    facing = torch.sum(n * p_cam, dim=-1, keepdim=True)
    flip = facing > 0.0
    n = torch.where(flip, -n, n)
    return _Terms(p_cam, in_depth, zs, rz, cov_c, (j00, j02, j11, j12),
                  (ju0, ju2, jv0, jv1, jv2), (a_raw, b_raw, c_raw), a, b, c,
                  det, ok_det, det_safe, ratio, ratio_pos, compensation,
                  inv_det, conic, mean2d, (s_ut, s_vt), plane, n_raw, n_len,
                  flip, n)


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
    t = _terms(means, quats, scales, viewmat, K, eps2d, near_plane,
               far_plane)
    a, c, det = t.a, t.c, t.det

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

    u0, v0 = t.mean2d[..., 0], t.mean2d[..., 1]
    on_screen = ((u0 + radius > 0) & (u0 - radius < width)
                 & (v0 + radius > 0) & (v0 - radius < height))
    valid = t.in_depth & t.ok_det & on_screen & (radius > radius_clip)

    radius = torch.where(valid, radius, torch.zeros_like(radius))
    radius_xy = torch.where(valid[:, None], radius_xy,
                            torch.zeros_like(radius_xy))
    return Projection(
        mean2d=t.mean2d,
        depth=t.p_cam[..., 2],
        conic=t.conic,
        radius=radius,
        compensation=t.compensation,
        plane=t.plane,
        normal=t.normal,
        valid=valid,
        radius_xy=radius_xy,
    )


def _zero_or(g, shape, like):
    return torch.zeros(shape, dtype=like.dtype, device=like.device) \
        if g is None else g


def project_backward(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    eps2d: float,
    near_plane: float,
    far_plane: float,
    v_mean2d: torch.Tensor | None,
    v_depth: torch.Tensor | None,
    v_conic: torch.Tensor | None,
    v_plane: torch.Tensor | None,
    v_normal: torch.Tensor | None,
    v_compensation: torch.Tensor | None,
    camera: bool = False,
) -> tuple:
    """The gradient of :func:`project_gaussians` with respect to means,
    quats and scales, given the cotangents of its six differentiable
    outputs (None for an output that takes none): (v_means [N, 3], v_quats
    [N, 4], v_scales [N, 3], v_viewmat [4, 4], v_K [3, 3]), the last two
    (sums over the rows, zero where the projection reads nothing) only
    with ``camera`` and None otherwise.

    The plain version of ``csrc/projection.cu``'s backward, step for step
    in its order: the intermediates are recomputed from the inputs, and
    every ``where``, clamp and ``+ 1e-12`` of the forward passes the
    gradient autograd passes (0 at the compensation and det clamps, 0
    through the ``zs = 1`` of rows outside the depth range).
    """
    n = means.shape[0]
    t = _terms(means, quats, scales, viewmat, K, eps2d, near_plane,
               far_plane)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    W = viewmat[:3, :3]
    x, y = t.p_cam[..., 0], t.p_cam[..., 1]
    j00, j02, j11, j12 = t.j
    ju0, ju2, jv0, jv1, jv2 = t.ju
    a_raw, b_raw, c_raw = t.raw
    s_ut, s_vt = t.s_t
    cc = t.cov_c
    c00, c01, c02 = cc[..., 0, 0], cc[..., 0, 1], cc[..., 0, 2]
    c11, c12, c22 = cc[..., 1, 1], cc[..., 1, 2], cc[..., 2, 2]
    k0, k1, k2 = t.conic.unbind(-1)
    pu, pv = t.plane.unbind(-1)
    u, v = t.mean2d.unbind(-1)
    g_m2 = _zero_or(v_mean2d, (n, 2), means)
    g_k = _zero_or(v_conic, (n, 3), means)
    g_pl = _zero_or(v_plane, (n, 2), means)
    g_n = _zero_or(v_normal, (n, 3), means)
    g_comp = _zero_or(v_compensation, (n,), means)
    g_depth = _zero_or(v_depth, (n,), means)

    # The normal: the facing flip, then n_raw / n_len.
    g_n = torch.where(t.flip, -g_n, g_n)
    il = 1.0 / t.n_len
    dot = torch.sum(g_n * t.n_raw, dim=-1, keepdim=True)
    g_nr = g_n * il - t.n_raw * (dot * il * il * il)
    g_nr0, g_nr1, g_nr2 = g_nr.unbind(-1)
    # n_raw = (-pu fx, -pv fy, pu (u - cx) + pv (v - cy) + zs).
    g_pu = g_pl[..., 0] - fx * g_nr0 + (u - cx) * g_nr2
    g_pv = g_pl[..., 1] - fy * g_nr1 + (v - cy) * g_nr2
    g_u = g_m2[..., 0] + pu * g_nr2
    g_v = g_m2[..., 1] + pv * g_nr2
    g_zs = g_nr2
    # plane = conic (s_ut, s_vt).
    g_k0 = g_k[..., 0] + g_pu * s_ut
    g_k1 = g_k[..., 1] + g_pu * s_vt + g_pv * s_ut
    g_k2 = g_k[..., 2] + g_pv * s_vt
    g_sut = g_pu * k0 + g_pv * k1
    g_svt = g_pu * k1 + g_pv * k2
    # conic = (c, -b, a) / det_safe.
    g_a = g_k2 * t.inv_det
    g_b = -g_k1 * t.inv_det
    g_c = g_k0 * t.inv_det
    g_inv = g_k0 * t.c - g_k1 * t.b + g_k2 * t.a
    g_ds = -g_inv * t.inv_det * t.inv_det
    # compensation = sqrt(ratio) where ratio > 1e-12, else 0.
    g_ratio = torch.where(t.ratio_pos, g_comp / (2.0 * t.compensation),
                          torch.zeros_like(g_comp))
    g_det_raw = g_ratio / t.det_safe
    g_ds = g_ds - g_ratio * t.ratio / t.det_safe
    g_det = torch.where(t.ok_det, g_ds, torch.zeros_like(g_ds))
    # det = a c - b^2 and det_raw = a_raw c_raw - b_raw^2 (a = a_raw + eps).
    g_a_raw = g_a + g_det * t.c + g_det_raw * c_raw
    g_c_raw = g_c + g_det * t.a + g_det_raw * a_raw
    g_b_raw = g_b - 2.0 * t.b * g_det - 2.0 * b_raw * g_det_raw
    # Sigma2D = J Sigma_c J^T, the plane's J Sigma_c e_z folded in.
    g_ju0 = g_a_raw * j00
    g_ju2 = g_a_raw * j02 + g_sut
    g_jv0 = g_b_raw * j00
    g_jv1 = g_c_raw * j11
    g_jv2 = g_b_raw * j02 + g_c_raw * j12 + g_svt
    g_j00 = g_a_raw * ju0 + g_b_raw * jv0 + g_ju0 * c00 + g_ju2 * c02
    g_j02 = g_a_raw * ju2 + g_b_raw * jv2 + g_ju0 * c02 + g_ju2 * c22
    g_j11 = g_c_raw * jv1 + g_jv0 * c01 + g_jv1 * c11 + g_jv2 * c12
    g_j12 = g_c_raw * jv2 + g_jv0 * c02 + g_jv1 * c12 + g_jv2 * c22
    g_c00 = g_ju0 * j00
    g_c01 = g_jv0 * j11
    g_c02 = g_ju0 * j02 + g_ju2 * j00 + g_jv0 * j12
    g_c11 = g_jv1 * j11
    g_c12 = g_jv1 * j12 + g_jv2 * j11
    g_c22 = g_ju2 * j02 + g_jv2 * j12
    # J = [[fx rz, 0, -fx x rz^2], [0, fy rz, -fy y rz^2]] and mean2d.
    rz = t.rz
    rz2 = rz * rz
    g_x = -fx * rz2 * g_j02 + fx * rz * g_u
    g_y = -fy * rz2 * g_j12 + fy * rz * g_v
    g_rz2 = -fx * x * g_j02 - fy * y * g_j12
    g_rz = fx * g_j00 + fy * g_j11 + fx * x * g_u + fy * y * g_v \
        + 2.0 * rz * g_rz2
    g_zs = g_zs - g_rz * rz * rz
    g_z = g_depth + torch.where(t.in_depth, g_zs, torch.zeros_like(g_zs))
    g_p = torch.stack([g_x, g_y, g_z], dim=-1)
    v_means = g_p @ W

    # Sigma_c = W Sigma_w W^T reads its upper triangle: with Gs = G_c +
    # G_c^T, Sigma_w = M M^T and M = R diag(s), G_M = W^T Gs W M.
    gs = torch.stack([
        torch.stack([2.0 * g_c00, g_c01, g_c02], -1),
        torch.stack([g_c01, 2.0 * g_c11, g_c12], -1),
        torch.stack([g_c02, g_c12, 2.0 * g_c22], -1),
    ], dim=-2)
    R = quat_to_rotmat(quats)
    gs_w = gs @ W
    g_M = W.T @ gs_w @ (R * scales[..., None, :])
    v_scales = torch.sum(g_M * R, dim=-2)
    G = g_M * scales[..., None, :]
    q_len = torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True)
                       + 1e-12)
    w, qx, qy, qz = (quats / q_len).unbind(-1)
    g_qn = 2.0 * torch.stack([
        -qz * G[:, 0, 1] + qy * G[:, 0, 2] + qz * G[:, 1, 0]
        - qx * G[:, 1, 2] - qy * G[:, 2, 0] + qx * G[:, 2, 1],
        qy * G[:, 0, 1] + qz * G[:, 0, 2] + qy * G[:, 1, 0]
        - 2.0 * qx * G[:, 1, 1] - w * G[:, 1, 2] + qz * G[:, 2, 0]
        + w * G[:, 2, 1] - 2.0 * qx * G[:, 2, 2],
        -2.0 * qy * G[:, 0, 0] + qx * G[:, 0, 1] + w * G[:, 0, 2]
        + qx * G[:, 1, 0] + qz * G[:, 1, 2] - w * G[:, 2, 0]
        + qz * G[:, 2, 1] - 2.0 * qy * G[:, 2, 2],
        -2.0 * qz * G[:, 0, 0] - w * G[:, 0, 1] + qx * G[:, 0, 2]
        + w * G[:, 1, 0] - 2.0 * qz * G[:, 1, 1] + qy * G[:, 1, 2]
        + qx * G[:, 2, 0] + qy * G[:, 2, 1],
    ], dim=-1)
    # qn = q / q_len.
    iq = 1.0 / q_len
    v_quats = g_qn * iq - quats * (torch.sum(quats * g_qn, dim=-1,
                                             keepdim=True) * iq * iq * iq)
    if not camera:
        return v_means, v_quats, v_scales, None, None

    # The camera: p_cam = W m + t gives g_p m^T and g_p; Sigma_c = W Sigma_w
    # W^T gives Gs W Sigma_w; J, mean2d and n_raw give the intrinsics' (cx
    # reaches the normal's u - cx twice, which cancel).
    g_wt = torch.cat([g_p[:, :, None] * means[:, None, :]
                      + gs_w @ covariance3d(quats, scales),
                      g_p[:, :, None]], dim=-1)               # [N, 3, 4]
    g_fx = g_j00 * rz - x * rz2 * g_j02 + x * rz * g_u - pu * g_nr0
    g_fy = g_j11 * rz - y * rz2 * g_j12 + y * rz * g_v - pv * g_nr1
    g_intr = torch.stack([g_fx, g_fy, g_m2[..., 0], g_m2[..., 1]], dim=-1)
    v_viewmat = torch.zeros_like(viewmat)
    v_viewmat[:3] = g_wt.sum(dim=0)
    fx_fy_cx_cy = g_intr.sum(dim=0)
    v_K = torch.zeros_like(K)
    v_K[0, 0], v_K[1, 1], v_K[0, 2], v_K[1, 2] = fx_fy_cx_cy.unbind()
    return v_means, v_quats, v_scales, v_viewmat, v_K

"""Plain reference of one render: projection, SH colours, tile binning
with the per-tile window and its spill order, and depth-ordered
compositing of colour, normal, alpha, expected and median depth.

Plain PyTorch, float32, no kernel, importing nothing of the program.  It
follows the method's published description as the port's configuration
states it (RaDe-GS on gsplat's tiled rasterizer: EWA projection with the
ray-plane depth and normal, 16-pixel tiles, a front-to-back window of the
``tile_capacity`` front-most splats per tile, alpha cut at 1/255 and
clamped at 0.999), and reproduces the program's discrete choices step by
step in PyTorch's order of operations: the global intersection budget,
the exact depth ranks, the exact ellipse-tile cull, the stable
(tile | rank) sort, the window cut and the median slot.  Every product
goes through :class:`~.precision.Products`.

Compositing runs in blocks of tiles.  :func:`composite_maps` makes the
maps without a graph (the log-transmittance carried slot by slot, so that
the median slot is chosen on the same float32 sums as a sequential
carry); :func:`composite_backward` recomputes each block under autograd
and back-propagates the maps' cotangents into the packed per-Gaussian
rows, so that no whole-image [T, 256, K] graph is ever held.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .precision import Products

ALPHA_CUTOFF = 1.0 / 255.0
ALPHA_MAX = 0.999
LOG_HALF = -0.6931471805599453
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# Columns of the packed per-Gaussian rows: u, v | conic a, b, c | depth |
# plane (2) | opacity | values (normal ++ colours ++ latents).
G_VALS = 9


class Cam(NamedTuple):
    K: torch.Tensor      # [3, 3]
    c2w: torch.Tensor    # [4, 4] OpenGL camera-to-world
    width: int
    height: int


def camera(rig_entry: dict, device) -> Cam:
    return Cam(torch.as_tensor(rig_entry["K"], device=device),
               torch.as_tensor(rig_entry["c2w"], device=device),
               int(rig_entry["width"]), int(rig_entry["height"]))


def viewmat(cam: Cam, prec: Products) -> torch.Tensor:
    """COLMAP world-to-camera [4, 4]: y and z of the OpenGL axes negated,
    then the rigid inverse."""
    diag = torch.tensor((1.0, -1.0, -1.0), device=cam.c2w.device)
    R = cam.c2w[:3, :3] * diag[None, :]
    t = cam.c2w[:3, 3]
    w2c = torch.zeros((4, 4), device=cam.c2w.device)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = -prec.matmul(R.T, t)
    w2c[3, 3] = 1.0
    return w2c


# ------------------------------------------------------------ projection
def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    q = quats / torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True)
                           + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
         2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
         2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
         1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


class Proj(NamedTuple):
    mean2d: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor
    plane: torch.Tensor
    normal: torch.Tensor
    valid: torch.Tensor
    radius_xy: torch.Tensor
    compensation: torch.Tensor


def project(means, quats, scales, opacities, cam: Cam, opts: dict,
            prec: Products) -> Proj:
    """EWA projection with RaDe-GS's depth plane and normal.  ``scales``
    are linear, ``opacities`` activated [N]; the per-axis bbox is that of
    the alpha >= 1/255 ellipse of each splat's own opacity."""
    vm = viewmat(cam, prec)
    K = cam.K
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R_wc, t_wc = vm[:3, :3], vm[:3, 3]
    near, far, eps2d = opts["near_plane"], opts["far_plane"], opts["eps2d"]

    p_cam = prec.matmul(means, R_wc.T) + t_wc
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    in_depth = (z > near) & (z < far)
    zs = torch.where(in_depth, z, torch.ones_like(z))

    M = quat_to_rotmat(quats) * scales[..., None, :]
    cov_w = prec.matmul(M, M.transpose(-1, -2))
    cov_c = prec.einsum("ij,njk,lk->nil", R_wc, cov_w, R_wc)

    rz = 1.0 / zs
    rz2 = rz * rz
    j00, j02 = fx * rz, -fx * x * rz2
    j11, j12 = fy * rz, -fy * y * rz2
    c00, c01, c02 = cov_c[..., 0, 0], cov_c[..., 0, 1], cov_c[..., 0, 2]
    c11, c12, c22 = cov_c[..., 1, 1], cov_c[..., 1, 2], cov_c[..., 2, 2]
    ju0 = j00 * c00 + j02 * c02
    ju2 = j00 * c02 + j02 * c22
    jv0 = j11 * c01 + j12 * c02
    jv1 = j11 * c11 + j12 * c12
    jv2 = j11 * c12 + j12 * c22
    a_raw = ju0 * j00 + ju2 * j02
    b_raw = jv0 * j00 + jv2 * j02
    c_raw = jv1 * j11 + jv2 * j12

    det_raw = a_raw * c_raw - b_raw * b_raw
    a, b, c = a_raw + eps2d, b_raw, c_raw + eps2d
    det = a * c - b * b
    ok_det = det > 1e-12
    det_safe = torch.where(ok_det, det, torch.ones_like(det))
    ratio = det_raw / det_safe
    ratio_pos = ratio > 1e-12
    compensation = torch.where(
        ratio_pos,
        torch.sqrt(torch.where(ratio_pos, ratio, torch.ones_like(ratio))),
        torch.zeros_like(ratio))

    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mean2d = torch.stack([fx * x * rz + cx, fy * y * rz + cy], dim=-1)

    mid = 0.5 * (a + c)
    eig_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(eig_max, min=0.0)))
    cut = torch.sqrt(2.0 * torch.clamp(
        torch.log(255.0 * torch.clamp(opacities.detach(), 0.0, 1.0)),
        min=0.0))
    rx = torch.ceil(torch.minimum(cut * torch.sqrt(torch.clamp(a, min=0.0)),
                                  radius))
    ry = torch.ceil(torch.minimum(cut * torch.sqrt(torch.clamp(c, min=0.0)),
                                  radius))

    s_ut = j00 * c02 + j02 * c22
    s_vt = j11 * c12 + j12 * c22
    plane_u = conic[..., 0] * s_ut + conic[..., 1] * s_vt
    plane_v = conic[..., 1] * s_ut + conic[..., 2] * s_vt
    plane = torch.stack([plane_u, plane_v], dim=-1)

    nz = plane_u * (mean2d[..., 0] - cx) + plane_v * (mean2d[..., 1] - cy) + zs
    n = torch.stack([-plane_u * fx, -plane_v * fy, nz], dim=-1)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    facing = torch.sum(n * p_cam, dim=-1, keepdim=True)
    n = torch.where(facing > 0.0, -n, n)

    u0, v0 = mean2d[..., 0], mean2d[..., 1]
    on_screen = ((u0 + radius > 0) & (u0 - radius < cam.width)
                 & (v0 + radius > 0) & (v0 - radius < cam.height))
    valid = in_depth & ok_det & on_screen & (radius > opts["radius_clip"])
    radius_xy = torch.where(valid[:, None], torch.stack([rx, ry], dim=-1),
                            torch.zeros_like(mean2d))
    return Proj(mean2d, z, conic, plane, n, valid, radius_xy, compensation)


# ------------------------------------------------------------ SH colours
def sh_basis(dirs: torch.Tensor, num_bases: int) -> torch.Tensor:
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    basis = [torch.full_like(x, SH_C0)]
    if num_bases > 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if num_bases > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                  SH_C2[4] * (xx - yy)]
    if num_bases > 9:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(basis, dim=-1)


def colors(params: Dict[str, torch.Tensor], cam: Cam, active_degree: int,
           sh_degree: int, latent_dim: int, prec: Products) -> torch.Tensor:
    """[N, 3 + L] channels: SH evaluated in world space toward the camera
    centre, +0.5 and clamped at 0 (sigmoid of the DC term at degree 0),
    then the latents."""
    if sh_degree > 0:
        coeffs = torch.cat([params["features_dc"][:, None, :],
                            params["features_rest"]], dim=1)
        dirs = params["means"] - cam.c2w[:3, 3][None, :]
        nb = coeffs.shape[1]
        norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)
                          + 1e-12)
        basis = sh_basis(dirs / norm, nb)
        degs = torch.tensor([int(b ** 0.5 + 1e-6) for b in range(nb)],
                            device=coeffs.device)
        mask = (degs <= active_degree).to(torch.float32)
        rgb = prec.einsum("nk,nkc->nc", basis * mask[None, :], coeffs)
        rgb = torch.clamp(rgb + 0.5, min=0.0)
    else:
        rgb = torch.sigmoid(params["features_dc"])
    if latent_dim:
        rgb = torch.cat([rgb, params["distill_features"]], dim=-1)
    return rgb


# --------------------------------------------------------------- binning
class Bins(NamedTuple):
    tile_gauss: torch.Tensor   # [T, K] int64 gaussian per window slot
    tile_mask: torch.Tensor    # [T, K] bool
    ntx: int
    nty: int
    spilled: int               # intersections dropped by both cuts


def _min_sigma_rect(mu, mv, a, b, c, u0, u1, v0, v1):
    """Least sigma of the splat over a tile's pixel rectangle."""
    du0, du1 = u0 - mu, u1 - mu
    dv0, dv1 = v0 - mv, v1 - mv
    inside = (du0 <= 0) & (du1 >= 0) & (dv0 <= 0) & (dv1 >= 0)

    def sig(du, dv):
        return 0.5 * (a * du * du + c * dv * dv) + b * du * dv

    c_safe = torch.clamp(c, min=1e-12)
    a_safe = torch.clamp(a, min=1e-12)
    best = torch.minimum(
        torch.minimum(sig(du0, torch.clamp(-b * du0 / c_safe, dv0, dv1)),
                      sig(du1, torch.clamp(-b * du1 / c_safe, dv0, dv1))),
        torch.minimum(sig(torch.clamp(-b * dv0 / a_safe, du0, du1), dv0),
                      sig(torch.clamp(-b * dv1 / a_safe, du0, du1), dv1)))
    return torch.where(inside, torch.zeros_like(best), best)


def tile_capacity(n: int, opts: dict) -> int:
    if opts["tile_capacity"]:
        return int(opts["tile_capacity"])
    cap = 512
    while cap > 8 and cap > 2 * n:
        cap //= 2
    return cap


def max_intersections(n: int, opts: dict) -> int:
    if opts["max_intersections"]:
        return int(opts["max_intersections"])
    return int(min(max(8 * n, 1 << 15), 1 << 24))


@torch.no_grad()
def bin_tiles(proj: Proj, opac: torch.Tensor, width: int, height: int,
              opts: dict) -> Bins:
    """Per-tile front-to-back windows of the splats whose alpha >= 1/255
    ellipse touches the tile: whole splats past the global budget dropped
    in id order, exact depth ranks, the exact ellipse-tile cull, a stable
    (tile | rank) sort, the ``tile_capacity`` front-most kept."""
    n = proj.depth.shape[0]
    dev = proj.depth.device
    ts = opts["tile_size"]
    ntx, nty = -(-width // ts), -(-height // ts)
    num_tiles = ntx * nty
    m_cap = max_intersections(n, opts)
    k_cap = tile_capacity(n, opts)

    u, v = proj.mean2d[:, 0], proj.mean2d[:, 1]
    rx, ry = proj.radius_xy[:, 0], proj.radius_xy[:, 1]

    def cell(x, hi):
        return torch.clamp(torch.floor(x / ts), 0, hi - 1).to(torch.int64)

    tx0, ty0 = cell(u - rx, ntx), cell(v - ry, nty)
    tx1, ty1 = cell(u + rx, ntx), cell(v + ry, nty)
    ncols, nrows = tx1 - tx0 + 1, ty1 - ty0 + 1
    counts = torch.where(proj.valid, ncols * nrows, torch.zeros_like(ncols))
    approx = torch.cumsum(counts.to(torch.float32), dim=0)
    keep0 = approx <= float(m_cap)
    ck = torch.where(keep0, counts, torch.zeros_like(counts))
    off = torch.cumsum(ck, dim=0) - ck
    keep = keep0 & (off + ck <= m_cap)
    kept = torch.where(keep, counts, torch.zeros_like(counts))
    dropped = int(counts.sum() - kept.sum())
    counts = kept
    offsets = torch.cumsum(counts, dim=0) - counts

    tile_bits = max(int(np.ceil(np.log2(num_tiles + 2))), 1)
    rank_bits = 31 - tile_bits
    if not opts["exact_binning"]:
        raise ValueError("the reference bins with exact depth ranks only")
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depth, inf),
                          stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev)
    n_bits = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    if n_bits > rank_bits:
        rank = rank >> (n_bits - rank_bits)

    # Slot -> owning splat: each splat's id at its first slot, carried
    # forward by a running max.
    total = int(offsets[-1] + counts[-1]) if n else 0
    seed = torch.full((m_cap + 1,), -1, dtype=torch.int64, device=dev)
    pos = torch.where(counts > 0, offsets, torch.full_like(offsets, m_cap))
    seed.scatter_reduce_(0, pos, torch.arange(n, device=dev), reduce="amax")
    owner = torch.cummax(seed[:m_cap], dim=0).values
    slots = torch.arange(m_cap, device=dev)
    live = (slots < total) & (owner >= 0)
    owner = torch.clamp(owner, 0, max(n - 1, 0))
    local = slots - offsets[owner]
    nc = torch.clamp(ncols[owner], min=1)
    dy = torch.div(local, nc, rounding_mode="floor")
    dx = local - dy * nc
    tile = ty0[owner] * ntx + tx0[owner] + dy * ntx + dx
    if opts["ellipse_cull"]:
        thresh = torch.log(torch.clamp(opac / ALPHA_CUTOFF, min=1e-12))
        tx = (tile % ntx).to(torch.float32) * ts
        ty = torch.div(tile, ntx, rounding_mode="floor").to(
            torch.float32) * ts
        con = proj.conic[owner]
        ms = _min_sigma_rect(u[owner], v[owner], con[:, 0], con[:, 1],
                             con[:, 2], tx, tx + ts, ty, ty + ts)
        live = live & (ms <= thresh[owner])
    key = torch.where(live, (tile << rank_bits) | rank[owner],
                      torch.full_like(tile, num_tiles << rank_bits))
    gid = torch.where(live, owner, torch.zeros_like(owner))
    skey, perm = torch.sort(key, stable=True)
    sgid = gid[perm]

    bounds = torch.searchsorted(
        skey, torch.arange(num_tiles + 1, device=dev) << rank_bits)
    starts, ends = bounds[:-1], bounds[1:]
    win = starts[:, None] + torch.arange(k_cap, device=dev)[None, :]
    mask = win < ends[:, None]
    tile_gauss = sgid[torch.clamp(win, 0, m_cap - 1)]
    spill = int(torch.clamp(ends - starts - k_cap, min=0).sum())
    return Bins(tile_gauss, mask, ntx, nty, dropped + spill)


# ------------------------------------------------------------ compositing
def pack(proj: Proj, opac: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """[N, 9 + 3 + C] packed rows: u, v, conic, depth, plane, opacity,
    then normal ++ ``vals``."""
    return torch.cat([proj.mean2d, proj.conic, proj.depth[:, None],
                      proj.plane, opac[:, None], proj.normal, vals], dim=1)


def _pixels(tiles: torch.Tensor, ntx: int, ts: int):
    p = torch.arange(ts * ts, device=tiles.device)
    up = (tiles % ntx)[:, None] * ts + (p % ts)[None, :]
    vp = (tiles // ntx)[:, None] * ts + (p // ts)[None, :]
    return up.to(torch.float32) + 0.5, vp.to(torch.float32) + 0.5


def _alpha(g, msk, up, vp):
    du = up[:, :, None] - g[:, None, :, 0]
    dv = vp[:, :, None] - g[:, None, :, 1]
    sigma = 0.5 * (g[:, None, :, 2] * du * du + g[:, None, :, 4] * dv * dv) \
        + g[:, None, :, 3] * du * dv
    alpha = torch.clamp(g[:, None, :, 8] * torch.exp(
        -torch.clamp(sigma, 0.0, 50.0)), max=ALPHA_MAX)
    keep = msk[:, None, :] & (alpha.detach() >= ALPHA_CUTOFF) \
        & (sigma.detach() >= 0.0)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    return du, dv, alpha


def _rows(per_gauss, bins: Bins, sl: slice):
    idx = bins.tile_gauss[sl]
    g = per_gauss.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + (per_gauss.shape[1],))
    return g, bins.tile_mask[sl]


class TileMaps(NamedTuple):
    """Per-tile maps [T, P, ...] of a render."""

    vals: torch.Tensor    # [T, P, V] normal ++ colours ++ latents
    alpha: torch.Tensor
    depth_acc: torch.Tensor
    median: torch.Tensor
    med_idx: torch.Tensor  # [T, P] median's window slot


@torch.no_grad()
def composite_maps(per_gauss: torch.Tensor, bins: Bins, opts: dict,
                   prec: Products, tile_chunk: int = 128) -> TileMaps:
    """Front-to-back compositing of every tile's window, without a
    graph.  The log-transmittance is carried slot by slot in float32."""
    ts, near = opts["tile_size"], opts["near_plane"]
    t_all, k = bins.tile_gauss.shape
    parts = []
    for s in range(0, t_all, tile_chunk):
        sl = slice(s, min(s + tile_chunk, t_all))
        g, msk = _rows(per_gauss, bins, sl)
        up, vp = _pixels(torch.arange(sl.start, sl.stop,
                                      device=g.device), bins.ntx, ts)
        du, dv, alpha = _alpha(g, msk, up, vp)
        log1m = torch.log1p(-alpha).permute(2, 0, 1).contiguous()
        excl = torch.empty_like(log1m)
        incl = torch.empty_like(log1m)
        carry = torch.zeros_like(log1m[0])
        for j in range(k):
            excl[j] = carry
            carry = carry + log1m[j]
            incl[j] = carry
        excl, incl = excl.permute(1, 2, 0), incl.permute(1, 2, 0)
        w = alpha * torch.exp(excl)
        tpix = torch.clamp(g[:, None, :, 5] + g[:, None, :, 6] * du
                           + g[:, None, :, 7] * dv, min=near)
        vals = prec.einsum("tpk,tkv->tpv", w, g[..., G_VALS:])
        a_out = 1.0 - torch.exp(carry)
        depth_acc = torch.sum(w * tpix, dim=-1)
        crossed = (incl <= LOG_HALF) & (alpha > 0.0)
        kk = torch.arange(k, device=g.device)
        rank_key = 2.0 + (k - kk).to(torch.float32) / k
        idx = torch.argmax(torch.where(crossed, rank_key, w), dim=-1)
        med = torch.gather(tpix, -1, idx[..., None])[..., 0]
        med = torch.where(a_out > 0.0, med, torch.zeros_like(med))
        parts.append((vals, a_out, depth_acc, med, idx))
    return TileMaps(*(torch.cat(x, dim=0) for x in zip(*parts)))


def composite_backward(per_gauss: torch.Tensor, bins: Bins, opts: dict,
                       prec: Products, med_idx: torch.Tensor,
                       cot: TileMaps, tile_chunk: int = 64) -> None:
    """Back-propagate the tile maps' cotangents ``cot`` (its ``vals``,
    ``alpha``, ``depth_acc`` and ``median``) into ``per_gauss.grad``: each
    block of tiles recomputed under autograd, the median slot held at the
    forward's choice."""
    ts, near = opts["tile_size"], opts["near_plane"]
    t_all = bins.tile_gauss.shape[0]
    for s in range(0, t_all, tile_chunk):
        sl = slice(s, min(s + tile_chunk, t_all))
        g, msk = _rows(per_gauss, bins, sl)
        up, vp = _pixels(torch.arange(sl.start, sl.stop,
                                      device=g.device), bins.ntx, ts)
        du, dv, alpha = _alpha(g, msk, up, vp)
        log1m = torch.log1p(-alpha)
        incl = torch.cumsum(log1m, dim=-1)
        w = alpha * torch.exp(incl - log1m)
        tpix = torch.clamp(g[:, None, :, 5] + g[:, None, :, 6] * du
                           + g[:, None, :, 7] * dv, min=near)
        vals = prec.einsum("tpk,tkv->tpv", w, g[..., G_VALS:])
        a_out = 1.0 - torch.exp(incl[..., -1])
        depth_acc = torch.sum(w * tpix, dim=-1)
        med = torch.gather(tpix, -1, med_idx[sl][..., None])[..., 0]
        med = torch.where(a_out.detach() > 0.0, med, torch.zeros_like(med))
        torch.autograd.backward(
            [vals, a_out, depth_acc, med],
            [cot.vals[sl], cot.alpha[sl], cot.depth_acc[sl], cot.median[sl]])


def stitch(x: torch.Tensor, bins: Bins, ts: int, width: int,
           height: int) -> torch.Tensor:
    """[T, P, ...] tile maps to an [H, W, ...] image."""
    ch = x.shape[2:]
    x = x.reshape((bins.nty, bins.ntx, ts, ts) + ch).transpose(1, 2)
    return x.reshape((bins.nty * ts, bins.ntx * ts) + ch)[:height, :width]


@torch.no_grad()
def pair_counts(per_gauss: torch.Tensor, bins: Bins, opts: dict,
                tile_chunk: int = 128):
    """(masked-in window slots, (pixel, slot) pairs whose alpha passes the
    cutoff): the work of a render, counted on this binning."""
    ts = opts["tile_size"]
    t_all = bins.tile_gauss.shape[0]
    live = 0
    for s in range(0, t_all, tile_chunk):
        sl = slice(s, min(s + tile_chunk, t_all))
        g, msk = _rows(per_gauss, bins, sl)
        up, vp = _pixels(torch.arange(sl.start, sl.stop, device=g.device),
                         bins.ntx, ts)
        live += int((_alpha(g, msk, up, vp)[2] > 0).sum())
    return int(bins.tile_mask.sum()), live

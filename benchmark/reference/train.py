"""Plain reference of the RaDe-GS and rade-features training step and of
the viewer's render.

The step: the render of :mod:`.render`, the outputs as RaDe-GS forms them
(background blend, expected and median depth backfilled where nothing was
hit, the two depth-to-normal error maps), the loss (L1 + SSIM, the
depth-normal consistency term, and for rade-features the decoded latents'
cosine distillation against each tower's map), its gradients by autograd
through a two-pass compositing backward, dead rows zeroed, and per-group
Adam with nerfstudio's learning-rate schedules.  The configuration's file
gives every number; nothing is read from the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import render as R
from .precision import Products


# ------------------------------------------------------------------ maps
def depth_pair_to_normal(cam: R.Cam, d1: torch.Tensor,
                         d2: torch.Tensor) -> torch.Tensor:
    """[2, H, W, 3] normals of two z-depth maps by central differences of
    their back-projected points (a zero one-pixel border)."""
    u = torch.arange(cam.width, dtype=torch.float32, device=d1.device) + 0.5
    v = torch.arange(cam.height, dtype=torch.float32,
                     device=d1.device) + 0.5
    u = u[None, :].expand(cam.height, cam.width)
    v = v[:, None].expand(cam.height, cam.width)
    x = (u - cam.K[0, 2]) / cam.K[0, 0]
    y = (v - cam.K[1, 2]) / cam.K[1, 1]
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def normal(d):
        p = rays * d.reshape(cam.height, cam.width)[..., None]
        d_row = p[2:, 1:-1, :] - p[:-2, 1:-1, :]
        d_col = p[1:-1, 2:, :] - p[1:-1, :-2, :]
        n = torch.linalg.cross(d_row, d_col, dim=-1)
        n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
        return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))

    return torch.stack([normal(d1), normal(d2)], dim=0)


def _window_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter(img: torch.Tensor, prec: Products) -> torch.Tensor:
    """Separable 11-tap Gaussian, 'valid', per channel of [H, W, C]."""
    c = img.shape[2]
    win = torch.as_tensor(_window_1d(), device=img.device)
    x = img.permute(2, 0, 1)[None]
    x = prec.conv2d(x, win.view(1, 1, 11, 1).expand(c, 1, 11, 1), c)
    x = prec.conv2d(x, win.view(1, 1, 1, 11).expand(c, 1, 1, 11), c)
    return x[0].permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor, prec: Products) -> torch.Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu0, mu1 = _filter(a, prec), _filter(b, prec)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _filter(a * a, prec) - mu00
    s11 = _filter(b * b, prec) - mu11
    s01 = _filter(a * b, prec) - mu01
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den)


# -------------------------------------------------------------- features
def resample_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] antialiased triangle-kernel weights with half-pixel
    centres (``jax.image.resize(method="linear")``)."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0).astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(w.T), device=device)


def resize(x: torch.Tensor, size, prec: Products) -> torch.Tensor:
    """Resize axes 0 and 1 of [H, W, C] to ``size``."""
    h, w = size
    if x.shape[0] != h:
        m = resample_matrix(x.shape[0], h, x.device)
        x = prec.matmul(m, x.reshape(x.shape[0], -1)).reshape(
            h, x.shape[1], -1)
    if x.shape[1] != w:
        m = resample_matrix(x.shape[1], w, x.device)
        x = prec.matmul(m, x)
    return x


def feature_loss(latents: torch.Tensor, targets: Dict[str, torch.Tensor],
                 dec: Dict[str, torch.Tensor], model: dict,
                 prec: Products) -> torch.Tensor:
    """Decoded latents' cosine distillation: the latent map resized to
    the main tower's map, the shared ReLU layer and one head per tower,
    the other towers' maps resized to their own size; weight 1 on the
    main tower and ``features_regularization_lambda`` on the others, times
    ``features_loss_lambda``."""
    dims = model["feature_dims"]
    main = model["main_feature_name"]
    _, mh, mw = dims[main]
    x = resize(latents, (mh, mw), prec)
    h = torch.relu(prec.linear(x, dec["hidden_w"], dec["hidden_b"]))
    total = torch.zeros((), device=latents.device)
    for name in sorted(dims):
        m = prec.linear(h, dec[f"branch_{name}_w"], dec[f"branch_{name}_b"])
        if name != main:
            m = resize(m, (dims[name][1], dims[name][2]), prec)
        pred, gt = m.permute(2, 0, 1), targets[name]
        num = torch.sum(pred * gt, dim=0)
        den = torch.sqrt(torch.sum(pred * pred, dim=0) + 1e-16) \
            * torch.sqrt(torch.sum(gt * gt, dim=0) + 1e-16)
        weight = 1.0 if name == main \
            else model["features_regularization_lambda"]
        total = total + weight * torch.mean(1.0 - num / den)
    return total * model["features_loss_lambda"]


# ------------------------------------------------------------ the step
def _prepare(params, alive, cam, step, model, prec):
    opts = model["render"]
    opac = torch.sigmoid(params["opacities"][:, 0]) * alive.to(torch.float32)
    proj = R.project(params["means"], params["quats"],
                     torch.exp(params["scales"]), opac, cam, opts, prec)
    proj = proj._replace(valid=proj.valid & alive)
    if opts["rasterize_mode"] == "antialiased":
        opac = opac * proj.compensation
    sh = model["sh_degree"]
    active = min(int(step) // model["sh_degree_interval"], sh) if sh else 0
    cols = R.colors(params, cam, active, model["sh_degree"],
                    model["latent_dim"], prec)
    per_gauss = R.pack(proj, opac, cols)
    bins = R.bin_tiles(proj, opac.detach(), cam.width, cam.height, opts)
    return per_gauss, bins


def _images(tiles: R.TileMaps, bins: R.Bins, cam: R.Cam, opts: dict):
    ts = opts["tile_size"]

    def st(x):
        return R.stitch(x, bins, ts, cam.width, cam.height)

    vals, alpha = st(tiles.vals), st(tiles.alpha)
    depth = st(tiles.depth_acc)
    if opts["normalize_depth"]:
        depth = depth / torch.clamp(alpha, min=1e-10)
    return vals, alpha, depth, st(tiles.median)


def render_rgb(params, alive, cam: R.Cam, step: int, model: dict,
               prec: Products) -> torch.Tensor:
    """The evaluation render's [H, W, 3] colour on a black background,
    clamped to [0, 1]: what the viewer shows in its ``rgb`` mode."""
    with torch.no_grad():
        per_gauss, bins = _prepare(params, alive, cam, step, model, prec)
        tiles = R.composite_maps(per_gauss, bins, model["render"], prec)
        vals, alpha, _, _ = _images(tiles, bins, cam, model["render"])
        return torch.clamp(vals[..., 3:6], 0.0, 1.0)


def loss_and_grads(params: Dict[str, torch.Tensor], alive: torch.Tensor,
                   cam: R.Cam, image: torch.Tensor,
                   targets: Optional[Dict[str, torch.Tensor]],
                   dec: Optional[Dict[str, torch.Tensor]], bg: torch.Tensor,
                   step: int, model: dict, prec: Products,
                   half: bool = False):
    """(total loss, its gradients for every parameter and decoder tensor)
    of one training step on ``cam`` against ``image`` (and the towers'
    ``targets``), with the depth-normal term on.  ``half`` takes the
    per-pixel terms over the top half of the image only (a fault that the
    benchmark's check has to catch)."""
    opts = model["render"]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    dleaves = {k: v.detach().requires_grad_(True)
               for k, v in (dec or {}).items()}
    per_gauss, bins = _prepare(leaves, alive, cam, step, model, prec)
    pg = per_gauss.detach().requires_grad_(True)
    tiles = R.composite_maps(pg.detach(), bins, opts, prec)
    tl = R.TileMaps(*(x.clone().requires_grad_(True) for x in tiles[:4]),
                    tiles.med_idx)
    vals, alpha, depth, median = _images(tl, bins, cam, opts)

    rgb = torch.clamp(vals[..., 3:6] + (1.0 - alpha[..., None]) * bg,
                      0.0, 1.0)
    hit = alpha > 0.0

    def backfill(x):
        return torch.where(hit, x, torch.max(x).detach())

    normal = vals[..., :3]
    rows = slice(0, cam.height // 2 if half else cam.height)
    rgb_l, image_l = rgb[rows], image[rows]
    l1 = torch.mean(torch.abs(rgb_l - image_l))
    lam = model["ssim_lambda"]
    loss = (1.0 - lam) * l1 + lam * (1.0 - ssim(rgb_l, image_l, prec))
    if model["use_depth_normal_loss"] and \
            step >= model["regularization_from_iter"]:
        dn = depth_pair_to_normal(cam, backfill(depth), backfill(median))
        err = (1.0 - torch.sum(normal[None] * dn, dim=-1))[:, rows]
        r = model["depth_ratio"]
        loss = loss + model["depth_normal_lambda"] * (
            (1.0 - r) * torch.mean(err[0]) + r * torch.mean(err[1]))
    if targets is not None:
        latents = vals[..., 6:6 + model["latent_dim"]]
        loss = loss + feature_loss(latents, targets, dleaves, model, prec)
    loss.backward()
    cot = R.TileMaps(*(torch.zeros_like(x) if x.grad is None else x.grad
                       for x in tl[:4]), None)
    R.composite_backward(pg, bins, opts, prec, tiles.med_idx, cot)
    per_gauss.backward(pg.grad)
    amask = alive.to(torch.float32)
    grads = {}
    for k, v in leaves.items():
        gk = torch.zeros_like(v) if v.grad is None else v.grad
        grads[k] = gk * amask.reshape((-1,) + (1,) * (gk.dim() - 1))
    for k, v in dleaves.items():
        grads["decoder/" + k] = torch.zeros_like(v) if v.grad is None \
            else v.grad
    return float(loss.detach()), grads


def lr_at(spec: dict, step: int) -> float:
    """nerfstudio's exponential decay: a sine warm-up from
    ``lr_pre_warmup``, then a log-space lerp from ``lr`` to ``lr_final``
    over ``max_steps``."""
    lr = spec["lr"]
    lr_final = spec.get("lr_final") or lr
    warm = spec.get("warmup_steps", 0)
    if step < warm:
        pre = spec.get("lr_pre_warmup", 1e-8)
        return pre + (lr - pre) * math.sin(0.5 * math.pi * min(
            max(step / warm, 0.0), 1.0))
    t = (step - warm) / max(spec.get("max_steps", 30000) - warm, 1)
    t = min(max(t, 0.0), 1.0)
    return math.exp(math.log(lr) * (1.0 - t) + math.log(lr_final) * t)


class Adam:
    """Per-group Adam (betas from the configuration, each group's eps) on
    a dict of tensors; the moments start at zero and the update count at
    ``count``, which also places each group's schedule."""

    def __init__(self, groups: Dict[str, dict], betas, count: int):
        self.groups, self.betas, self.count = groups, betas, count
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        t = self.count + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for k, g in grads.items():
            spec = self.groups[k.split("/")[0]]
            lr = lr_at(spec, self.count)
            m = self.m.get(k, torch.zeros_like(g))
            v = self.v.get(k, torch.zeros_like(g))
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            self.m[k], self.v[k] = m, v
            denom = torch.sqrt(v) / math.sqrt(bc2) + spec["eps"]
            params[k] = params[k] - (lr / bc1) * m / denom
        self.count = t


def refine_alive(params, alive, step: int, strategy: dict,
                 trainer: dict) -> torch.Tensor:
    """The alive mask once the step counter has reached ``step``: past
    the densification window a refine step (every ``refine_every`` after
    the warm-up) only culls (``continue_cull_post_densification``): rows
    whose opacity is under ``cull_alpha_thresh``, and once scale culling
    is on, rows whose largest scale passes ``cull_scale_thresh`` times the
    scene scale.  Refines that densify, cull by screen size or reset the
    opacities are not followed: they raise."""
    s = strategy
    if not (step > s["warmup_length"] and step % s["refine_every"] == 0
            and step < trainer["max_iterations"]):
        return alive
    period = s["reset_alpha_every"] * s["refine_every"]
    if step < s["stop_split_at"] or step < s["stop_screen_size_at"]:
        raise ValueError(f"the reference follows cull-only refines alone; "
                         f"step {step} densifies or culls by screen size")
    if not s["continue_cull_post_densification"]:
        return alive
    opac = torch.sigmoid(params["opacities"][:, 0])
    culled = opac < s["cull_alpha_thresh"]
    if step > period:
        scale_max = torch.amax(torch.exp(params["scales"]), dim=-1)
        culled = culled | (scale_max > s["cull_scale_thresh"]
                           * trainer["scene_scale"])
    return alive & ~culled


def train_steps(params, alive, rig, images, targets, dec, steps: List[int],
                views: List[int], backgrounds: List[torch.Tensor],
                model: dict, optimizer: dict, count: int, prec: Products,
                strategy: dict, trainer: dict, half: bool = False,
                cull: bool = True):
    """Run the reference over ``steps`` (each on its drawn view and
    background), with the cull-only refines that fall among them
    (``cull=False`` leaves them out: a fault for the check to catch).
    Returns (the losses, each leaf's first gradient, the parameters after
    the last step, the alive mask after it), leaves named as the
    program's parameters and ``decoder/<name>``."""
    state = {k: v.detach().clone() for k, v in params.items()}
    for k, v in (dec or {}).items():
        state["decoder/" + k] = v.detach().clone()
    groups = dict(optimizer["groups"])
    opt = Adam(groups, tuple(optimizer["betas"]), count)
    losses, first = [], None
    for step, view, bg in zip(steps, views, backgrounds):
        cam = R.camera(rig[view], alive.device)
        p = {k: v for k, v in state.items() if "/" not in k}
        d = {k.split("/", 1)[1]: v for k, v in state.items() if "/" in k}
        loss, grads = loss_and_grads(
            p, alive, cam, images[view],
            None if targets is None else targets[view], d or None, bg, step,
            model, prec, half)
        losses.append(loss)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        # A step with a non-finite gradient is skipped, schedule and all.
        if all(bool(torch.isfinite(g).all()) for g in grads.values()):
            opt.step(state, grads)
        if cull:
            alive = refine_alive(state, alive, step + 1, strategy, trainer)
    return losses, first, state, alive

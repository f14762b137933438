"""Seeded inputs of a cell, made on the device in a few large calls.

Both sides of the comparison get these same tensors: the program as its
training start, images, feature maps, cameras and decoder weights, and the
plain reference, which makes them again from the same seed once the
program's state is freed.  The generators are frozen copies of what the
program's own tools draw (``data/synthetic.py::random_gaussian_params``
and ``orbit_cameras``, ``chip_smoke.py::perturbed_init``), so the inputs
cannot drift with the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def sub_seed(seed: int, salt: int) -> int:
    """A generator seed for stream ``salt`` of a run's ``--seed``."""
    return (int(seed) * 1_000_003 + 7919 * salt) % (1 << 62)


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, salt))


def gaussian_table(seed: int, n_alive: int, capacity: int, sh_degree: int,
                   latent_dim: int, extent: float, scale_range, device,
                   perturbed: bool) -> Dict[str, torch.Tensor]:
    """Raw parameters [capacity, ...] in the reference layout.

    The first ``n_alive`` rows are ``random_gaussian_params``' draws (means
    uniform in the cube of half-side ``extent``, log-scales of a uniform
    draw in ``scale_range``, normal quaternions normalised, logit opacity
    uniform in [0.5, 3], colours uniform in [0.1, 0.9] as SH DC, the rest
    bands 0.01 normal, zero latents).  With ``perturbed`` they are shaped
    as ``perturbed_init`` leaves a training start: 5% of the rows five
    times larger and 5% faint (opacity 0.05).  The rows past ``n_alive``
    are dead padding: unit quaternion, logit opacity -10, log-scale -15.
    """
    g = generator(seed, 1, device)
    n = n_alive
    u = torch.rand((n, 13), generator=g, device=device)
    means = extent * (2.0 * u[:, 0:3] - 1.0)
    lo, hi = scale_range
    log_scales = torch.log(lo + (hi - lo) * u[:, 3:6])
    opac = 0.5 + 2.5 * u[:, 6:7]
    rgb = 0.1 + 0.8 * u[:, 7:10]
    nrest = (sh_degree + 1) ** 2 - 1
    r = torch.randn((n, 4 + 3 * nrest), generator=g, device=device)
    quats = r[:, :4] / torch.linalg.norm(r[:, :4], dim=-1, keepdim=True)
    rest = 0.01 * r[:, 4:].reshape(n, nrest, 3)
    if perturbed:
        pick = u[:, 10:11]
        log_scales = torch.where(pick < 0.05, log_scales + math.log(5.0),
                                 log_scales)
        opac = torch.where(pick > 0.95,
                           torch.full_like(opac, math.log(0.05 / 0.95)),
                           opac)
    pad = capacity - n
    dev = device
    out = {
        "means": torch.cat([means, torch.zeros(pad, 3, device=dev)]),
        "scales": torch.cat([log_scales,
                             torch.full((pad, 3), -15.0, device=dev)]),
        "quats": torch.cat([quats, torch.tensor(
            [[1.0, 0.0, 0.0, 0.0]], device=dev).expand(pad, 4)]),
        "opacities": torch.cat([opac, torch.full((pad, 1), -10.0,
                                                 device=dev)]),
        "features_dc": torch.cat([(rgb - 0.5) / SH_C0,
                                  torch.zeros(pad, 3, device=dev)]),
        "features_rest": torch.cat([rest, torch.zeros(pad, nrest, 3,
                                                      device=dev)]),
    }
    if latent_dim:
        out["distill_features"] = torch.zeros(capacity, latent_dim,
                                              device=dev)
    return {k: v.contiguous() for k, v in out.items()}


def alive_mask(n_alive: int, capacity: int, device) -> torch.Tensor:
    return torch.arange(capacity, device=device) < n_alive


def look_at_c2w(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenGL camera-to-world [4, 4] looking from ``eye`` at ``target``,
    z up (``data/synthetic.py::look_at_c2w``)."""
    up = np.array([0.0, 0.0, 1.0])
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def orbit_rig(n_views: int, radius: float, width: int, height: int,
              focal: float, elevation: float = 0.4) -> List[dict]:
    """``orbit_cameras``' rig as plain arrays: per view the intrinsics K
    [3, 3] and the OpenGL c2w [4, 4], float32, and the image size."""
    target = np.zeros(3)
    rig = []
    for i in range(n_views):
        ang = 2.0 * np.pi * i / max(n_views, 1)
        eye = target + radius * np.array(
            [np.cos(ang), np.sin(ang), np.sin(elevation)])
        K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0],
                      [0.0, 0.0, 1.0]], np.float32)
        rig.append({"K": K, "c2w": look_at_c2w(eye, target),
                    "width": width, "height": height})
    return rig


def smooth_images(seed: int, n: int, height: int, width: int,
                  device) -> torch.Tensor:
    """[n, H, W, 3] ground-truth images in [0, 1]: seeded 9x16 colour
    fields, bilinearly upsampled.  The step's cost does not depend on the
    image content; these images need no render of the program."""
    g = generator(seed, 2, device)
    low = torch.rand((n, 3, 9, 16), generator=g, device=device)
    img = torch.nn.functional.interpolate(low, size=(height, width),
                                          mode="bilinear",
                                          align_corners=False)
    return img.permute(0, 2, 3, 1).contiguous()


def feature_maps(seed: int, n: int, dims: Dict[str, list],
                 device) -> List[Dict[str, torch.Tensor]]:
    """Per view {branch: [C, h, w]} seeded normal maps: the towers'
    targets at their shapes (no tower weights are in the repository)."""
    g = generator(seed, 3, device)
    stacks = {name: torch.randn((n, *shape), generator=g, device=device)
              for name, shape in sorted(dims.items())}
    return [{name: s[i] for name, s in stacks.items()} for i in range(n)]


def decoder_weights(seed: int, latent_dim: int, hidden: int,
                    dims: Dict[str, list], device) -> Dict[str, torch.Tensor]:
    """The two-layer decoder's weights under its checkpoint names, in
    ``nn.Linear``'s [out, in] layout: He-normal weights, biases uniform in
    +-1/sqrt(fan_in), as the program's decoder draws them."""
    g = generator(seed, 4, device)
    out = {}
    layers = [("hidden", latent_dim, hidden)] + [
        (f"branch_{name}", hidden, shape[0])
        for name, shape in sorted(dims.items())]
    for name, fan_in, fan_out in layers:
        w = torch.randn((fan_out, fan_in), generator=g, device=device)
        b = torch.rand((fan_out,), generator=g, device=device)
        out[f"{name}_w"] = w * math.sqrt(2.0 / fan_in)
        out[f"{name}_b"] = (2.0 * b - 1.0) / math.sqrt(fan_in)
    return out


def trainer_seed(seed: int, n_views: int, start_step: int,
                 n_check: int) -> int:
    """The trainer's own seed for a run: below 400,000 (the trainer keys
    numpy's 32-bit RandomState by it), and the first of its kind whose
    camera draws for the first ``n_check`` steps are all different views,
    so that the checked steps train on different images."""
    s = int(seed) % 400_000
    while True:
        views = {camera_draw(s, start_step + j, n_views)
                 for j in range(n_check)}
        if len(views) == n_check:
            return s
        s = (s + 1) % 400_000


def camera_draw(trainer_seed_: int, step: int, n_views: int) -> int:
    """The trainer's host-side, step-keyed camera draw (a frozen copy of
    ``Trainer.train_one_step``'s)."""
    return int(np.random.RandomState(trainer_seed_ * 9973 + step).randint(
        n_views))

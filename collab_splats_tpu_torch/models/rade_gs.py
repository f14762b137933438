"""RaDe-GS model: the forward outputs of one camera.

Counterpart of the JAX package's ``models/rade_gs.py`` for the inference
path: colours from SH, one tiled render, background blend and the
reference's output dict.  The depth->normal error maps, the loss stack and
the ``backend="pallas"`` renderer come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.cameras import Camera
from ..core.options import RenderOptions
from ..core.sh import eval_sh
from ..ops.rasterize import RenderMeta, render_tiled
from .gaussians import GaussianParams, activated_opacity, activated_scales


@dataclasses.dataclass(frozen=True)
class RadeGSConfig:
    """Model configuration of the forward render; field names and defaults
    are the JAX package's.  Its loss fields (``ssim_lambda``,
    ``use_scale_regularization``, ``max_gauss_ratio``,
    ``regularization_from_iter``, ``use_depth_normal_loss``,
    ``depth_normal_lambda``, ``depth_ratio``) and ``prefilter_voxel`` come
    with the training slice.
    """

    sh_degree: int = 3
    sh_degree_interval: int = 1000
    background: str = "random"          # "random" | "black" | "white"
    latent_dim: int = 0                 # 13 for rade-features
    render: RenderOptions = RenderOptions()

    def active_sh_degree(self, step: int) -> int:
        if self.sh_degree <= 0:
            return 0
        return min(int(step) // self.sh_degree_interval, self.sh_degree)


def background_color(config: RadeGSConfig,
                     generator: Optional[torch.Generator], training: bool,
                     device=None) -> torch.Tensor:
    """[3] background: white, black, or (training with a generator) a
    uniform random colour drawn from ``generator``."""
    if config.background == "white":
        return torch.ones(3, dtype=torch.float32, device=device)
    if config.background == "black" or generator is None or not training:
        return torch.zeros(3, dtype=torch.float32, device=device)
    bg = torch.rand(3, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return bg.to(device)


def compute_colors(params: GaussianParams, camera: Camera, step: int,
                   config: RadeGSConfig) -> torch.Tensor:
    """Per-Gaussian rasterization channels [N, 3 + latent_dim].

    SH evaluated in world space against the camera centre, +0.5 and
    clamped at 0; ``sigmoid(features_dc)`` at sh_degree 0.
    """
    if config.sh_degree > 0:
        coeffs = torch.cat(
            [params["features_dc"][:, None, :], params["features_rest"]],
            dim=1)
        dirs = params["means"] - camera.camera_center()[None, :]
        rgb = eval_sh(coeffs, dirs, config.active_sh_degree(step))
        rgb = torch.clamp(rgb + 0.5, min=0.0)
    else:
        rgb = torch.sigmoid(params["features_dc"])
    if config.latent_dim:
        rgb = torch.cat([rgb, params["distill_features"]], dim=-1)
    return rgb


def get_outputs(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    step: int,
    config: RadeGSConfig,
    generator: Optional[torch.Generator] = None,
    training: bool = True,
    crop_box: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], RenderMeta]:
    """Render one camera and assemble the reference's output dict.

    Keys: rgb, depth (expected), median_depth, accumulation, normal_cam,
    normals ([0, 1]-mapped), background, spilled, plus "features" when
    latent_dim > 0.  ``crop_box`` ([2, 3] world-space min/max corners)
    keeps only the Gaussians inside the box.
    """
    if crop_box is not None:
        inside = torch.all((params["means"] >= crop_box[0][None, :])
                           & (params["means"] <= crop_box[1][None, :]),
                           dim=-1)
        alive = alive & inside
    colors = compute_colors(params, camera, step, config)
    out, meta = render_tiled(
        params["means"], params["quats"], activated_scales(params),
        activated_opacity(params, alive), colors, camera, config.render,
        alive_mask=alive.to(torch.bool),
    )
    bg = background_color(config, generator, training, device=out.color.device)
    rgb = torch.clamp(out.color[..., :3] + (1.0 - out.alpha[..., None]) * bg,
                      0.0, 1.0)

    alpha = out.alpha
    has_hit = alpha > 0.0

    # Out-of-alpha pixels take the (detached) map maximum, as the reference
    # does, so depth->normal borders stay sane.
    def backfill(x):
        return torch.where(has_hit, x, torch.max(x).detach())

    outputs: Dict[str, torch.Tensor] = {
        "rgb": rgb,
        "depth": backfill(out.depth),
        "median_depth": backfill(out.median_depth),
        "accumulation": alpha,
        "normal_cam": out.normal,
        "normals": (out.normal + 1.0) / 2.0,
        "background": bg,
        "spilled": out.spilled,
    }
    if config.latent_dim:
        outputs["features"] = out.color[..., 3:3 + config.latent_dim]
    return outputs, meta

"""RaDe-GS model: the outputs of one camera and the loss stack.

Counterpart of the JAX package's ``models/rade_gs.py``: colours from SH,
one tiled render, background blend, the reference's output dict with the
two depth->normal error maps, and the loss (L1 + SSIM, optional scale
regularization, the depth-normal consistency term from
``regularization_from_iter``).  ``config.render.backend`` picks the
renderer: ``render_tiled`` ("xla") or ``render_tiled_pallas`` ("pallas").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.cameras import Camera, depth_pair_to_normal
from ..core.options import RenderOptions
from ..core.sh import eval_sh
from ..ops.rasterize import RenderMeta, render_tiled, render_tiled_pallas
from ..train import losses
from .gaussians import GaussianParams, activated_opacity, activated_scales


@dataclasses.dataclass(frozen=True)
class RadeGSConfig:
    """Model configuration; field names and defaults are the JAX
    package's."""

    sh_degree: int = 3
    sh_degree_interval: int = 1000
    ssim_lambda: float = 0.2
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 10.0
    regularization_from_iter: int = 15000
    use_depth_normal_loss: bool = True
    depth_normal_lambda: float = 0.05
    depth_ratio: float = 0.6
    background: str = "random"          # "random" | "black" | "white"
    latent_dim: int = 0                 # 13 for rade-features
    render: RenderOptions = RenderOptions()
    # Accepted for parity with the reference config: binning already drops
    # every Gaussian with radius 0 (``Projection.valid``), so it changes
    # nothing.
    prefilter_voxel: bool = False

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
    compute_error_maps: bool = False,
    absgrad_sink: Optional[torch.Tensor] = None,
    crop_box: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], RenderMeta]:
    """Render one camera and assemble the reference's output dict.

    Keys: rgb, depth (expected), median_depth, accumulation, normal_cam,
    normals ([0, 1]-mapped), background, spilled, plus "features" when
    latent_dim > 0 and, with ``compute_error_maps``, the two depth-normal
    error maps [H, W, 1].  ``absgrad_sink`` is the rasterizer's
    screen-space sink (``ops/rasterize.py::absgrad_sink_shape``, or
    ``pallas_sink_shape`` for the "pallas" backend).
    ``crop_box`` ([2, 3] world-space min/max corners) keeps only the
    Gaussians inside the box.
    """
    if crop_box is not None:
        inside = torch.all((params["means"] >= crop_box[0][None, :])
                           & (params["means"] <= crop_box[1][None, :]),
                           dim=-1)
        alive = alive & inside
    colors = compute_colors(params, camera, step, config)
    render = render_tiled_pallas if config.render.backend == "pallas" \
        else render_tiled
    out, meta = render(
        params["means"], params["quats"], activated_scales(params),
        activated_opacity(params, alive), colors, camera, config.render,
        absgrad_sink=absgrad_sink, alive_mask=alive.to(torch.bool),
    )
    return outputs_from_render(out, camera, config, generator, training,
                               compute_error_maps), meta


def outputs_from_render(
    out,
    camera: Camera,
    config: RadeGSConfig,
    generator: Optional[torch.Generator] = None,
    training: bool = True,
    compute_error_maps: bool = False,
) -> Dict[str, torch.Tensor]:
    """:func:`get_outputs`' dict from a whole-image ``RenderOutput``."""
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

    if compute_error_maps:
        depth_normals = depth_pair_to_normal(camera, outputs["depth"],
                                             outputs["median_depth"])
        err = 1.0 - torch.sum(out.normal[None] * depth_normals, dim=-1)
        outputs["depth_normal_error_map"] = err[0][..., None]
        outputs["middepth_normal_error_map"] = err[1][..., None]
    return outputs


def get_loss(
    outputs: Dict[str, torch.Tensor],
    image: torch.Tensor,
    params: GaussianParams,
    alive: torch.Tensor,
    step: int,
    config: RadeGSConfig,
    reg_active: bool = False,
    scale_regularization: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and the per-term dict.

    ``reg_active`` switches the depth-normal term on (the trainer sets it
    from ``regularization_from_iter``); it needs the error maps of
    ``get_outputs(compute_error_maps=True)``.  ``scale_regularization=
    False`` leaves the anisotropy penalty out whatever the config says
    (the sharded step, whose processes hold a shard of ``params``).
    """
    loss_dict = {
        "rgb_loss": losses.rgb_loss(outputs["rgb"], image, config.ssim_lambda)
    }
    if config.use_scale_regularization and scale_regularization:
        # Splatfacto applies the anisotropy penalty only every 10th step.
        reg = losses.scale_regularization(
            params["scales"], alive.to(torch.float32), config.max_gauss_ratio)
        loss_dict["scale_reg"] = reg if step % 10 == 0 \
            else torch.zeros_like(reg)
    if reg_active and config.use_depth_normal_loss:
        loss_dict["depth_normal_loss"] = losses.depth_normal_loss(
            outputs["depth_normal_error_map"],
            outputs["middepth_normal_error_map"],
            config.depth_ratio,
            config.depth_normal_lambda,
        )
    total = sum(loss_dict.values())
    return total, loss_dict

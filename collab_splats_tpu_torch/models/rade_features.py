"""RaDe-Features model: RaDe-GS plus distilled feature splatting.

Counterpart of the JAX package's ``models/rade_features.py``:

* per-Gaussian 13-dim latents rendered fused with the colours (the RaDe-GS
  forward concatenates ``distill_features`` when ``latent_dim > 0``);
* a two-layer decoder to each feature space, trained with a weighted
  cosine distillation (weight 1 on the main branch, the regularization
  weight on the others, the whole term times ``features_loss_lambda``);
* text-query similarity maps and per-vertex queries at evaluation.

The decoder is a :class:`~..features.decoder.TwoLayerDecoder` held apart
from the per-Gaussian parameter dict (the JAX package nests it under
``params["decoder"]`` and has its refinement code skip that subtree).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.cameras import Camera
from ..features import decoder as decoder_lib
from ..features.similarity import compute_similarity
from ..ops.rasterize import RenderMeta
from ..train import losses
from . import rade_gs
from .gaussians import GaussianParams


@dataclasses.dataclass(frozen=True)
class RadeFeaturesConfig(rade_gs.RadeGSConfig):
    """Field names and defaults are the JAX package's."""

    latent_dim: int = 13
    mlp_hidden_dim: int = 64
    features_loss_lambda: float = 1e-3
    features_regularization_lambda: float = 0.1
    main_feature_name: str = "clip-vit"
    # branch name -> (C, H, W) of the ground-truth feature maps
    feature_dims: Tuple[Tuple[str, Tuple[int, int, int]], ...] = ()
    similarity_method: str = "pairwise"
    sh_degree: int = 0

    def feature_dims_dict(self) -> Dict[str, Tuple[int, int, int]]:
        return dict(self.feature_dims)


def init_feature_params(
    params: GaussianParams,
    config: RadeFeaturesConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[GaussianParams, decoder_lib.TwoLayerDecoder]:
    """The parameters with zero latents ``distill_features`` [C, L] added,
    and a decoder drawn from ``generator``, on the parameters' device."""
    out = dict(params)
    means = params["means"]
    out["distill_features"] = torch.zeros(
        (means.shape[0], config.latent_dim), device=means.device)
    dec = decoder_lib.TwoLayerDecoder(
        config.latent_dim, config.mlp_hidden_dim, config.feature_dims_dict(),
        generator=generator, device=means.device)
    return out, dec


def get_outputs(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    step: int,
    config: RadeFeaturesConfig,
    generator: Optional[torch.Generator] = None,
    training: bool = True,
    compute_error_maps: bool = False,
    absgrad_sink: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], RenderMeta]:
    """The RaDe-GS forward; its ``outputs["features"]`` [H, W, L] holds
    the rendered latents."""
    return rade_gs.get_outputs(
        params, alive, camera, step, config, generator=generator,
        training=training, compute_error_maps=compute_error_maps,
        absgrad_sink=absgrad_sink)


def feature_loss(outputs: Dict[str, torch.Tensor],
                 features_gt: Dict[str, torch.Tensor],
                 decoder: decoder_lib.TwoLayerDecoder,
                 config: RadeFeaturesConfig) -> torch.Tensor:
    """The weighted cosine distillation of the decoded rendered latents
    against ``features_gt`` (branch -> [C, H, W]), times
    ``features_loss_lambda``."""
    decoded = decoder_lib.decode_rendered_features(
        decoder, outputs["features"], config.feature_dims_dict(),
        config.main_feature_name)
    total = torch.zeros((), device=outputs["features"].device)
    for name, pred in decoded.items():
        weight = 1.0 if name == config.main_feature_name \
            else config.features_regularization_lambda
        total = total + weight * losses.cosine_distillation_loss(
            pred, features_gt[name])
    return total * config.features_loss_lambda


def get_loss(
    outputs: Dict[str, torch.Tensor],
    image: torch.Tensor,
    features_gt: Dict[str, torch.Tensor],
    params: GaussianParams,
    decoder: decoder_lib.TwoLayerDecoder,
    alive: torch.Tensor,
    step: int,
    config: RadeFeaturesConfig,
    reg_active: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RaDe-GS losses plus the feature distillation (``features_loss``)."""
    total, loss_dict = rade_gs.get_loss(outputs, image, params, alive, step,
                                        config, reg_active=reg_active)
    loss_dict["features_loss"] = feature_loss(outputs, features_gt, decoder,
                                              config)
    return total + loss_dict["features_loss"], loss_dict


def similarity_map(
    decoder: decoder_lib.TwoLayerDecoder,
    outputs: Dict[str, torch.Tensor],
    text_embeddings: torch.Tensor,
    num_positive: int,
    config: RadeFeaturesConfig,
    resize_factor: float = 8.0,
) -> torch.Tensor:
    """Text-query similarity map [H, W, 1] at the RGB resolution."""
    decoded = decoder_lib.decode_rendered_features(
        decoder, outputs["features"], config.feature_dims_dict(),
        config.main_feature_name, resize_factor=resize_factor)
    sim = compute_similarity(decoded[config.main_feature_name],
                             text_embeddings, num_positive,
                             method=config.similarity_method)
    h, w = outputs["rgb"].shape[:2]
    if sim.shape[:2] != (h, w):
        sim = decoder_lib.resize_bilinear(sim, (h, w))
    return sim


def query_vertices(
    decoder: decoder_lib.TwoLayerDecoder,
    vertex_features: torch.Tensor,
    text_embeddings: torch.Tensor,
    num_positive: int,
    config: RadeFeaturesConfig,
) -> torch.Tensor:
    """[V] similarities in [0, 1] of per-vertex latents [V, L] against
    the text queries."""
    feats = decoder_lib.decode(decoder, vertex_features)[
        config.main_feature_name]                           # [V, C]
    sim = compute_similarity(feats.T[:, :, None], text_embeddings,
                             num_positive, method=config.similarity_method)
    return sim[:, 0, 0]

"""Method registry: name -> trainer configuration and optimizer table.

Counterpart of the JAX package's ``pipeline/methods.py``: the four methods
the reference knows ("rade-gs" and "rade-features", registered as
nerfstudio methods, plus "splatfacto" and "feature-splatting") map onto
the two model families with flags set.  The entry point of a run is
``get_method(name).make_trainer_config(...)``, then ``Trainer`` with the
spec's ``groups``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from ..core.options import RenderOptions
from ..models import rade_features, rade_gs
from ..train import optim, strategy
from ..train.trainer import TrainerConfig


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    name: str
    description: str
    make_trainer_config: Callable[..., TrainerConfig]
    groups: Dict[str, optim.GroupSpec]
    has_features: bool = False


def _render_opts(rasterize_mode: str = "classic", **kw) -> RenderOptions:
    return RenderOptions(rasterize_mode=rasterize_mode, **kw)


def _rade_gs_config(sh_degree: int = 3, rasterize_mode: str = "classic",
                    use_depth_normal_loss: bool = True,
                    **kw) -> TrainerConfig:
    model = rade_gs.RadeGSConfig(
        sh_degree=sh_degree, use_depth_normal_loss=use_depth_normal_loss,
        render=_render_opts(rasterize_mode), **kw)
    # Splatfacto's progressive-resolution defaults, which the reference
    # inherits.
    return TrainerConfig(model=model, strategy=strategy.StrategyConfig(),
                         num_downscales=2, resolution_schedule=3000)


def _rade_features_config(feature_dims=(), main_feature_name: str = "clip-vit",
                          rasterize_mode: str = "classic",
                          use_depth_normal_loss: bool = True,
                          **kw) -> TrainerConfig:
    model = rade_features.RadeFeaturesConfig(
        use_depth_normal_loss=use_depth_normal_loss,
        feature_dims=tuple(feature_dims),
        main_feature_name=main_feature_name,
        render=_render_opts(rasterize_mode), **kw)
    return TrainerConfig(model=model, strategy=strategy.StrategyConfig(),
                         num_downscales=2, resolution_schedule=3000)


METHODS: Dict[str, MethodSpec] = {
    "rade-gs": MethodSpec(
        name="rade-gs",
        description="RaDe-GS: depth/normal rasterization + depth-normal "
        "consistency loss.",
        make_trainer_config=_rade_gs_config,
        groups=optim.RADE_GS_GROUPS,
    ),
    "splatfacto": MethodSpec(
        name="splatfacto",
        description="Vanilla splatting: RaDe-GS model without the "
        "depth-normal loss.",
        # splatfacto is without the depth-normal loss by definition; a
        # caller's value for it is dropped rather than raising a
        # duplicate-keyword TypeError.
        make_trainer_config=lambda **kw: _rade_gs_config(
            **{**kw, "use_depth_normal_loss": False}),
        groups=optim.RADE_GS_GROUPS,
    ),
    "rade-features": MethodSpec(
        name="rade-features",
        description="RaDe-GS + feature distillation.",
        make_trainer_config=_rade_features_config,
        groups=optim.RADE_FEATURES_GROUPS,
        has_features=True,
    ),
    "feature-splatting": MethodSpec(
        name="feature-splatting",
        description="Feature splatting without the depth-normal loss.",
        make_trainer_config=lambda **kw: _rade_features_config(
            **{**kw, "use_depth_normal_loss": False}),
        groups=optim.RADE_FEATURES_GROUPS,
        has_features=True,
    ),
}


def get_method(name: str) -> MethodSpec:
    if name not in METHODS:
        raise ValueError(f"Unknown method '{name}'. Available: "
                         f"{sorted(METHODS)}")
    return METHODS[name]

"""PyTorch + CUDA port of ``collab_splats_tpu``: RaDe-GS and feature
splatting (rade-features) on one CUDA card or several.

The port does all that the JAX package does: the tiled renderers and the
naive golden one, the training step and the trainer with its options,
rade-features, checkpoints and data loading, mesh extraction, the feature
towers, segmentation and grouping, the ``Splatter`` pipeline with its CLI
and viewer, multi-device training over ``torch.distributed``
(``parallel/``), the analytic ground-truth scene and profiling.  Its
layout mirrors the JAX package (``core/``, ``ops/``, ``models/``,
``train/``, ``data/``, ``features/``, ``meshing/``, ``parallel/``,
``pipeline/``, ``utils/``), so every module has a counterpart of the same
name.  The public names below import lazily, so ``import
collab_splats_tpu_torch`` stays cheap and builds no kernel.

The port imports ``torch`` and ``numpy`` only: nothing of JAX and nothing
of the JAX package.  The hand-written Hopper kernels live in ``csrc/`` and
are bound by ``ops/cuda/``; each has a plain PyTorch version beside it that
the wrappers use for tensors on the CPU only.

Precision: the JAX package pins ``Precision.HIGHEST`` on its geometry and
compositing contractions (core/projection.py, core/compositing.py) because
a reduced-precision product of world->camera positions or covariances
measurably degrades training.  On the GPU the analogue of that trap is TF32,
so it is switched off here, once, for every product the port runs.
"""

import importlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The JAX trainer resumes bit for bit because its reductions are
# deterministic; the port's kernels use no float atomics, and cuDNN (the
# SSIM filters) is held to deterministic algorithms too.
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "make_camera",
    "RenderOptions",
    "render_tiled",
    "render_tiled_pallas",
    "render_golden",
    "RadeGSConfig",
    "RadeFeaturesConfig",
    "Trainer",
    "TrainerConfig",
    "Splatter",
    "SplatViewer",
    "ConfigLoader",
    "parse_cli_overrides",
    "FullImageDatamanager",
    "TSDFFusionExporter",
    "GroupingClassifier",
]

_LAZY = {
    "Camera": "core.cameras",
    "make_camera": "core.cameras",
    "RenderOptions": "core.options",
    "render_tiled": "ops.rasterize",
    "render_tiled_pallas": "ops.rasterize",
    "render_golden": "core.golden",
    "RadeGSConfig": "models.rade_gs",
    "RadeFeaturesConfig": "models.rade_features",
    "Trainer": "train.trainer",
    "TrainerConfig": "train.trainer",
    "Splatter": "pipeline.splatter",
    "SplatViewer": "pipeline.viewer",
    "ConfigLoader": "pipeline.config",
    "parse_cli_overrides": "pipeline.config",
    "FullImageDatamanager": "data.datamanager",
    "TSDFFusionExporter": "meshing.exporters",
    "GroupingClassifier": "features.grouping",
}


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

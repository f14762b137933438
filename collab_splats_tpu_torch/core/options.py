"""Static rasterization options of the forward render."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Rasterizer configuration: every field that changes the outputs.

    Field names and defaults are those of the JAX package's
    ``core/options.py::RenderOptions``.  ``backend`` picks the compositor:
    ``"xla"`` (the batched window compositor of ``ops/cuda/batched.py``,
    the default) or ``"pallas"`` (the per-tile compositor of
    ``ops/cuda/composite.py`` over chunk-aligned intersection segments,
    with the tile-wide early exit at ``stop_threshold``); the names are
    the JAX package's, so a JAX configuration carries across unchanged.
    Left out, because they steer XLA's memory policy or select TPU kernels
    and change no output: ``pallas_interpret``, ``remat_compositing``,
    ``fused_vjp``, ``pallas_batched``, ``pallas_batched_bwd`` and
    ``remat_projection``.
    """

    tile_size: int = 16
    eps2d: float = 0.3
    near_plane: float = 0.01
    far_plane: float = 1e10
    rasterize_mode: str = "classic"  # "classic" | "antialiased"
    normalize_depth: bool = True
    radius_clip: float = 0.0

    # Capacities; ``None`` picks the heuristics of ops/tiles.py from N.
    max_intersections: int | None = None   # global (gaussian, tile) budget
    tile_capacity: int | None = None       # per-tile front-to-back window

    # Exact ellipse-vs-tile cull at binning time (drops entries whose alpha
    # is below the cutoff on every pixel of the tile; output-preserving).
    ellipse_cull: bool = True

    # Depth order inside tiles: exact global ranks, or quantized log-depth.
    exact_binning: bool = True

    # Compositor: "xla" (batched windows) or "pallas" (per-tile segments,
    # early exit once every pixel of a tile has T < stop_threshold; 0
    # never exits).
    backend: str = "xla"
    stop_threshold: float = 1e-4

    def __post_init__(self):
        if self.rasterize_mode not in ("classic", "antialiased"):
            raise ValueError(f"Unknown rasterize_mode: {self.rasterize_mode}")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"Unknown backend: {self.backend}")

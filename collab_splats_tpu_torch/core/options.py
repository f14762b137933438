"""Static rasterization options of the forward render."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Rasterizer configuration: every field that changes the outputs.

    Field names and defaults are those of the JAX package's
    ``core/options.py::RenderOptions``.  Left out, because they steer XLA's
    memory policy or select TPU kernels and change no output: ``backend``,
    ``stop_threshold``, ``pallas_interpret``, ``remat_compositing``,
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

    def __post_init__(self):
        if self.rasterize_mode not in ("classic", "antialiased"):
            raise ValueError(f"Unknown rasterize_mode: {self.rasterize_mode}")

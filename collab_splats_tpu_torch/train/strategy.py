"""Densify / prune strategy over a fixed-capacity table with an alive mask.

Counterpart of the JAX package's ``train/strategy.py`` (gsplat's
``DefaultStrategy`` as Splatfacto drives it):

* accumulate per-Gaussian screen-space gradient statistics every step
  (absolute values of the per-(tile, slot) mean gradients, recovered from
  the rasterizer's additive sink, per window slot or, for a
  ``backend="pallas"`` render, per intersection, summed per Gaussian by
  the sorted segment sum of ``ops/segsum.py``: no float atomics);
* every ``refine_every`` steps inside the densification window duplicate
  small high-gradient Gaussians, split large ones into ``n_split_samples``
  resampled children, cull transparent or oversized ones;
* periodically clamp opacities down (reset).

The table keeps the JAX package's capacity + alive-mask layout, so refine
decisions compare row for row: freed slots are ranked with a cumulative
sum, children go to free slots by rank, and children past the free slots
are dropped and counted (the trainer grows the capacity ahead of that).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..core.projection import quat_to_rotmat
from ..models.gaussians import GaussianParams
from ..ops.rasterize import RenderMeta
from ..ops.segsum import segment_sum, spread_masked
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    warmup_length: int = 500
    refine_every: int = 100
    densify_grad_thresh: float = 0.0008
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    split_scale_factor: float = 1.6
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    reset_alpha_every: int = 30          # in units of refine_every
    stop_split_at: int = 15000
    continue_cull_post_densification: bool = True
    use_absgrad: bool = True

    def is_refine_step(self, step: int) -> bool:
        return step > self.warmup_length and step % self.refine_every == 0

    def is_reset_step(self, step: int) -> bool:
        # Splatfacto resets refine_every steps after each interval
        # boundary, not on the boundary itself.
        period = self.reset_alpha_every * self.refine_every
        return (step > 0 and step % period == self.refine_every
                and step < self.stop_split_at)

    def splits_allowed(self, step: int) -> bool:
        return step < self.stop_split_at

    def densify_active(self, step: int, num_train_data: int) -> bool:
        """Whether dup/split run at this refine step: inside the window and
        past the pause that follows each opacity reset."""
        period = self.reset_alpha_every * self.refine_every
        return (step < self.stop_split_at
                and step % period > num_train_data + self.refine_every)

    def scale_cull_active(self, step: int) -> bool:
        return step > self.reset_alpha_every * self.refine_every

    def screen_size_active(self, step: int) -> bool:
        return step < self.stop_screen_size_at


class StrategyState(NamedTuple):
    grad_accum: torch.Tensor   # [C] accumulated NDC-scaled grad norms
    count: torch.Tensor        # [C] visibility counts
    max_radii: torch.Tensor    # [C] max screen radius / max(W, H)


def init_state(capacity: int, device=None) -> StrategyState:
    """Zero statistics for ``capacity`` rows, on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    return StrategyState(*(torch.zeros(capacity, device=dev)
                           for _ in range(3)))


def update_state(state: StrategyState, meta: RenderMeta,
                 sink_grad: torch.Tensor) -> StrategyState:
    """Accumulate the densification statistics after one backward pass.

    ``sink_grad`` [T, K, 2] is the gradient of the rasterizer's sink: the
    per-(tile, slot) screen-space gradient of the loss with respect to the
    2D means.  Its absolute values are summed per Gaussian (gsplat's
    ``absgrad`` statistic at tile granularity) and scaled to NDC units.
    """
    c = state.grad_accum.shape[0]
    mask = meta.bins.tile_mask.reshape(-1)
    g = torch.abs(sink_grad).reshape(-1, 2)
    g = torch.where(mask[:, None], g, torch.zeros_like(g))
    idx = spread_masked(meta.bins.tile_gauss.reshape(-1), mask, c)
    return _accumulate(state, meta, segment_sum(idx, g, c))


def update_state_from_isect(state: StrategyState, meta: RenderMeta,
                            sink_grad: torch.Tensor) -> StrategyState:
    """:func:`update_state` for a ``backend="pallas"`` render, whose sink
    gradient is per intersection: [2, M] over the aligned intersection list
    (``meta.aligned_gid``).  Padding slots are masked out and spread, and
    the per-Gaussian sums are the same sorted segment sum (the JAX package
    scatter-adds)."""
    c = state.grad_accum.shape[0]
    valid = meta.aligned_valid
    g = torch.abs(sink_grad).T
    g = torch.where(valid[:, None], g, torch.zeros_like(g))
    idx = spread_masked(meta.aligned_gid, valid, c)
    return _accumulate(state, meta, segment_sum(idx, g, c))


def _accumulate(state: StrategyState, meta: RenderMeta,
                guv: torch.Tensor) -> StrategyState:
    """NDC scaling (x max(W, H) / 2, the Splatfacto threshold convention),
    gradient norm, visibility counts and max radii."""
    scale = 0.5 * max(meta.width, meta.height)
    grad_ndc = torch.sqrt((guv[:, 0] * scale) ** 2 + (guv[:, 1] * scale) ** 2)
    radii_frac = meta.proj.radius.detach() / float(max(meta.width,
                                                       meta.height))
    return StrategyState(
        grad_accum=state.grad_accum + grad_ndc,
        count=state.count + meta.proj.valid.to(torch.float32),
        max_radii=torch.maximum(state.max_radii, radii_frac),
    )


def reset_opacity(params: GaussianParams,
                  cfg: StrategyConfig) -> GaussianParams:
    """Clamp opacities to at most 2 * cull_alpha_thresh (Splatfacto reset)."""
    cap = 2.0 * cfg.cull_alpha_thresh
    out = dict(params)
    out["opacities"] = torch.clamp(params["opacities"].detach(),
                                   max=math.log(cap / (1.0 - cap)))
    return out


class RefineResult(NamedTuple):
    params: GaussianParams
    alive: torch.Tensor
    written: torch.Tensor     # [C] rows newly written (optimizer state -> 0)
    state: StrategyState      # reset accumulators
    n_dup: torch.Tensor
    n_split: torch.Tensor
    n_cull: torch.Tensor
    dropped: torch.Tensor     # children dropped for lack of capacity


def split_noise(generator: Optional[torch.Generator], n_samples: int,
                capacity: int, device) -> torch.Tensor:
    """[n_samples, C, 3] standard normal draws for the split children's
    offsets, from ``generator`` (on its device)."""
    gen_dev = generator.device if generator is not None \
        else torch.device("cpu")
    return torch.randn((n_samples, capacity, 3), generator=generator,
                       device=gen_dev).to(device)


def _scatter_rows(dst, written, targets, src):
    """Rows ``src[i]`` to ``dst[targets[i]]``; a target of C drops the row.
    Live targets are distinct, so the result does not depend on order."""
    c = written.shape[0]

    def put(x, y):
        buf = torch.cat([x, x[:1]])   # row C catches the dropped rows
        buf[targets] = y
        return buf[:c]

    out = {k: put(v, src[k]) for k, v in dst.items()}
    return out, put(written, torch.ones_like(written))


@torch.no_grad()
def refine(
    params: GaussianParams,
    alive: torch.Tensor,
    state: StrategyState,
    cfg: StrategyConfig,
    generator: Optional[torch.Generator] = None,
    scene_scale: float = 1.0,
    allow_split: bool = True,
    scale_cull: bool = False,
    screen_size_cull: bool = False,
    allow_dup: bool = True,
    noise: Optional[torch.Tensor] = None,
) -> RefineResult:
    """One densify/prune pass over the capacity table.

    The flags come from the :class:`StrategyConfig` schedule helpers.
    ``allow_split=False, allow_dup=False`` gives the cull-only pass that
    runs after ``stop_split_at``.  The split children's offsets use
    ``noise`` [n_split_samples, C, 3] when given, else draws of
    :func:`split_noise` from ``generator``.
    """
    c = alive.shape[0]
    dev = alive.device
    opac = torch.sigmoid(params["opacities"][:, 0])
    scales = torch.exp(params["scales"])
    scale_max = torch.amax(scales, dim=-1)

    avg_grad = state.grad_accum / torch.clamp(state.count, min=1.0)
    high_grad = alive & (avg_grad > cfg.densify_grad_thresh) \
        & (state.count > 0)
    big_world = scale_max > cfg.densify_size_thresh * scene_scale
    big_screen = state.max_radii > cfg.split_screen_size

    is_split = high_grad & big_world
    if screen_size_cull:
        is_split = is_split | (high_grad & big_screen)
    if not allow_split:
        is_split = torch.zeros_like(is_split)
    is_dup = high_grad & ~big_world & ~is_split
    if not allow_dup:
        is_dup = torch.zeros_like(is_dup)

    culled = alive & (opac < cfg.cull_alpha_thresh)
    if scale_cull:
        culled = culled | (alive & (scale_max
                                    > cfg.cull_scale_thresh * scene_scale))
        if screen_size_cull:
            culled = culled | (alive & (state.max_radii
                                        > cfg.cull_screen_size))
    is_dup = is_dup & ~culled
    is_split = is_split & ~culled

    # Free slots come from dead and culled rows only; a split source is
    # removed only when all of its children fit.
    free = ~alive | culled
    n_free = torch.sum(free.to(torch.int64))
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    ranks = torch.where(free, free_rank, torch.full_like(free_rank, c))
    slot_of_rank = torch.full((c + 1,), c, dtype=torch.int64, device=dev)
    slot_of_rank[ranks] = torch.arange(c, device=dev)
    slot_of_rank = slot_of_rank[:c]

    n_items = cfg.n_split_samples
    n_dup = torch.sum(is_dup.to(torch.int64))
    total_split = torch.sum(is_split.to(torch.int64))
    split_rank = torch.cumsum(is_split.to(torch.int64), 0) - 1
    dup_rank = torch.cumsum(is_dup.to(torch.int64), 0) - 1
    # Split children rank first; a split fits iff its last child does.
    split_fits = is_split & ((split_rank + 1) * n_items <= n_free)
    survivors = alive & ~culled & ~split_fits

    src = {k: v.detach() for k, v in params.items()}
    new_params = dict(src)
    written = torch.zeros(c, dtype=torch.bool, device=dev)
    none = torch.full_like(split_rank, c)

    if noise is None:
        noise = split_noise(generator, n_items, c, dev)
    rot = quat_to_rotmat(src["quats"])
    split_scales = torch.log(torch.clamp(scales / cfg.split_scale_factor,
                                         min=1e-10))
    for j in range(n_items):
        offset = torch.einsum("nij,nj->ni", rot, scales * noise[j])
        child = dict(src, means=src["means"] + offset, scales=split_scales)
        item_rank = split_rank * n_items + j
        targets = torch.where(
            split_fits, slot_of_rank[torch.clamp(item_rank, 0, c - 1)], none)
        new_params, written = _scatter_rows(new_params, written, targets,
                                            child)

    # Duplicates: one copy per source, ranked after every split child.
    dup_item_rank = total_split * n_items + dup_rank
    dup_targets = torch.where(
        is_dup & (dup_item_rank < n_free),
        slot_of_rank[torch.clamp(dup_item_rank, 0, c - 1)], none)
    new_params, written = _scatter_rows(new_params, written, dup_targets, src)

    dropped = n_dup + total_split * n_items - torch.sum(
        written.to(torch.int64))
    return RefineResult(
        params=new_params,
        alive=survivors | written,
        written=written,
        state=StrategyState(*(torch.zeros(c, device=dev) for _ in range(3))),
        n_dup=n_dup,
        n_split=total_split,
        n_cull=torch.sum(culled.to(torch.int64)),
        dropped=dropped,
    )


@torch.no_grad()
def zero_opt_rows(optimizer: torch.optim.Optimizer,
                  written: torch.Tensor) -> None:
    """Zero the Adam moment rows of newly written Gaussians, in place, for
    every parameter whose leading dimension is the capacity; step counts
    are kept.  The decoder group holds no Gaussian rows and is skipped,
    whatever its shapes."""
    c = written.shape[0]
    for group in optimizer.param_groups:
        if group["name"] == "decoder":
            continue
        state = optimizer.state.get(group["params"][0], {})
        for key in ("exp_avg", "exp_avg_sq"):
            x = state.get(key)
            if x is not None and x.dim() >= 1 and x.shape[0] == c:
                x.masked_fill_(written.view((c,) + (1,) * (x.dim() - 1)),
                               0.0)

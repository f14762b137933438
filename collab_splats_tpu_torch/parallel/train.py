"""Sharded training step: camera-parallel x Gaussian-sharded processes.

Counterpart of the JAX package's ``parallel/train.py``, on a
(data, gauss) process mesh (``parallel/mesh.py``).  Per process, per step:

1. colours and the projection of the local Gaussian shard (C/G rows),
   packed under ``torch.utils.checkpoint`` into one differentiable
   [C/G, 12+C] matrix (``ops/rasterize.py::pack_per_gauss``'s layout) and
   one detached binning pack, so the backward recomputes the projection
   instead of keeping its intermediates;
2. both all-gathered over ``gauss``;
3. binning and compositing of the whole set against this row's camera
   (``render_from_projections(per_gauss=...)``: kernels 1 and 2 on the
   card), the RaDe loss with depth-normal when ``reg_active``;
4. backward: the all-gather transposes to a reduce-scatter, which sums
   every member's cotangent for a shard at its owner (kernels 3 and 4);
   the gradients of dead rows are zeroed and the gradients averaged over
   ``data``;
5. a per-shard ``torch.optim.Adam`` (the moments never leave the shard);
6. the densification statistics, summed per Gaussian by the sorted segment
   sum (kernel 4, no float atomics), summed over ``data`` (count, grad)
   or maxed (radii), kept sharded.

The whole-image loss is the same on every ``gauss`` member, so each member
differentiates 1/G of it: the reduce-scatter then sums member cotangents
to exactly the single-device gradient.  (The JAX step scales only its
tile-sharded loss so; its all-gather step's raw gradients are G times the
single-device ones, which Adam's scale invariance hides.)  The metrics
un-scale the loss.

``tile_sharded=True`` routes the projected rows to per-member tile bands
instead (``parallel/tiles.py``): per-process compositing buffers of
O(C/G + G * send_cap) rows; the statistics are computed per received slab
row and routed back to their shard with the reverse all-to-all.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..core.cameras import Camera
from ..core.projection import Projection, project_gaussians
from ..models import rade_gs
from ..ops.rasterize import (PG_CONIC, PG_DEPTH, PG_MEAN2D, PG_OPAC,
                             absgrad_sink_shape, pack_per_gauss,
                             render_from_projections)
from ..ops.segsum import segment_sum, spread_masked
from ..train import losses, strategy
from ..train.strategy import StrategyState
from ..train.trainer import step_generator
from .collectives import (all_gather_rows, all_reduce, exchange_rows,
                          gather_rows)
from .mesh import DATA_AXIS, GAUSS_AXIS, Mesh, unshard
from .tiles import band_rows, render_tile_sharded

# Columns of the detached binning pack: what bin_gaussians reads besides
# the packed matrix's mean, depth, conic and opacity (the statistics'
# visibility and radius among them).
_BP_RADIUS, _BP_LIVE, _BP_RADIUS_XY = 0, 1, slice(2, 4)


class CameraBatch(NamedTuple):
    """A batch of B cameras of one image size, one per ``data`` row."""

    K: torch.Tensor    # [B, 3, 3]
    c2w: torch.Tensor  # [B, 4, 4]


class ShardedTrainStep:
    """The step of :func:`make_sharded_train_step`; call it, or
    :meth:`gradients` for the gradients Adam would be fed."""

    def __init__(self, mesh: Mesh, optimizer, model_config, width: int,
                 height: int, capacity: int, reg_active: bool = False,
                 tile_sharded: bool = False,
                 send_cap: Optional[int] = None):
        n_gauss = mesh.n_gauss
        if capacity % n_gauss:
            raise ValueError(f"capacity {capacity} does not split into "
                             f"{n_gauss} shards")
        if not mesh.member:
            raise ValueError("this process is not in the mesh")
        self.mesh = mesh
        self.optimizer, self.scheduler = optimizer
        self.cfg = model_config
        self.width, self.height = width, height
        self.capacity = capacity
        self.shard = capacity // n_gauss
        self.reg_active = reg_active
        self.tile_sharded = tile_sharded
        opts = model_config.render
        if tile_sharded:
            self.send_cap = send_cap or self.shard
            self.band_px = band_rows(height, opts.tile_size,
                                     n_gauss) * opts.tile_size
            self.sink_shape = absgrad_sink_shape(
                width, self.band_px, n_gauss * self.send_cap, opts)
        else:
            self.sink_shape = absgrad_sink_shape(width, height, capacity,
                                                 opts)

    # ------------------------------------------------------------ pieces
    def _camera(self, cams: CameraBatch, images: torch.Tensor):
        n_data = self.mesh.n_data
        if cams.K.shape[0] != n_data:
            raise ValueError(
                f"sharded step needs exactly one camera per data shard: got "
                f"{cams.K.shape[0]} cameras for data axis size {n_data}")
        d = self.mesh.data_idx
        return (Camera(K=cams.K[d], c2w=cams.c2w[d], width=self.width,
                       height=self.height), images[d])

    def _project(self, camera, means, quats, scales, opac):
        opts = self.cfg.render
        return project_gaussians(
            means, quats, scales, camera.viewmat(), camera.K, self.width,
            self.height, eps2d=opts.eps2d, near_plane=opts.near_plane,
            far_plane=opts.far_plane, radius_clip=opts.radius_clip,
            opacities=opac)

    def _image_loss(self, out, camera, image, step_idx, generator):
        """The loss and the background-blended image from whole-image
        maps (``get_outputs`` + ``get_loss`` without scale
        regularization)."""
        cfg = self.cfg
        outputs = rade_gs.outputs_from_render(
            out, camera, cfg, generator, True,
            self.reg_active and cfg.use_depth_normal_loss)
        loss, _ = rade_gs.get_loss(outputs, image, None, None, step_idx, cfg,
                                   self.reg_active,
                                   scale_regularization=False)
        return loss, outputs["rgb"]

    def _render_gathered(self, p, alive, camera, step_idx, sink):
        """Steps 1-3 of the module doc: (RenderOutput, RenderMeta)."""
        opts = self.cfg.render
        colors = rade_gs.compute_colors(p, camera, step_idx, self.cfg)
        opac = torch.sigmoid(p["opacities"][:, 0]) * alive.to(torch.float32)

        def pack(means, quats, scales, opac, colors):
            pj = self._project(camera, means, quats, scales, opac)
            op = opac * pj.compensation \
                if opts.rasterize_mode == "antialiased" else opac
            per_gauss = pack_per_gauss(pj, op, pj.normal, colors)
            live = pj.valid & alive
            binpack = torch.cat([
                pj.radius[:, None], live[:, None].to(torch.float32),
                pj.radius_xy], dim=1)
            return per_gauss, binpack.detach()

        per_gauss, binpack = torch.utils.checkpoint.checkpoint(
            pack, p["means"], p["quats"], torch.exp(p["scales"]), opac,
            colors, use_reentrant=False)
        group = self.mesh.group(GAUSS_AXIS)
        per_gauss_full = all_gather_rows(per_gauss, group)
        bp = gather_rows(binpack, group)
        pg = per_gauss_full.detach()
        n, dev = bp.shape[0], bp.device
        proj_full = Projection(
            mean2d=pg[:, PG_MEAN2D], depth=pg[:, PG_DEPTH],
            conic=pg[:, PG_CONIC], radius=bp[:, _BP_RADIUS],
            compensation=torch.ones(n, device=dev),
            plane=torch.zeros((n, 2), device=dev),
            normal=torch.zeros((n, 3), device=dev),
            valid=bp[:, _BP_LIVE] > 0.5, radius_xy=bp[:, _BP_RADIUS_XY])
        return render_from_projections(
            proj_full, pg[:, PG_OPAC], None, None, camera, opts,
            absgrad_sink=sink, per_gauss=per_gauss_full)

    def _render_routed(self, p, alive, camera, step_idx, sink):
        """The tile-sharded render: (RenderOutput, RenderMeta, RouteInfo,
        the local projection)."""
        opts = self.cfg.render
        colors = rade_gs.compute_colors(p, camera, step_idx, self.cfg)
        opac = torch.sigmoid(p["opacities"][:, 0]) * alive.to(torch.float32)
        proj = torch.utils.checkpoint.checkpoint(
            lambda m, q, s, o: self._project(camera, m, q, s, o),
            p["means"], p["quats"], torch.exp(p["scales"]), opac,
            use_reentrant=False)
        # Dead rows stay out of the slabs and the tile windows.
        proj = proj._replace(valid=proj.valid & alive)
        if opts.rasterize_mode == "antialiased":
            opac = opac * proj.compensation
        out, meta, route = render_tile_sharded(
            proj, opac, colors, camera, opts, self.mesh, self.send_cap,
            absgrad_sink=sink)
        return out, meta, route, proj

    def _forward_backward(self, params, alive, cams, images, step_idx,
                          seed):
        """Loss, image, data-averaged gradients with dead rows zeroed, and
        what the statistics read."""
        mesh = self.mesh
        camera, image = self._camera(cams, images)
        alive = alive.to(torch.bool)
        dev = alive.device
        sink = torch.zeros(self.sink_shape, device=dev, requires_grad=True)
        gen = step_generator(seed, step_idx, 1, dev, mesh.data_idx)
        if self.tile_sharded:
            out, meta, route, proj_local = self._render_routed(
                params, alive, camera, step_idx, sink)
        else:
            out, meta = self._render_gathered(params, alive, camera,
                                              step_idx, sink)
            route = proj_local = None
        loss, rgb = self._image_loss(out, camera, image, step_idx, gen)
        names = list(params)
        grads = torch.autograd.grad(loss / mesh.n_gauss,
                                    [params[k] for k in names] + [sink],
                                    allow_unused=True)
        sink_grad = grads[-1]
        # Dead rows must not move: zero their gradients exactly.
        amask = alive.to(torch.float32)
        flat = []
        for k, g in zip(names, grads[:-1]):
            g = torch.zeros_like(params[k]) if g is None else g
            flat.append((g * amask.reshape((-1,) + (1,) * (g.dim() - 1)))
                        .reshape(-1))
        # The mean over data: one all-reduce of every gradient at once.
        mean = all_reduce(torch.cat(flat), mesh.group(DATA_AXIS)) \
            / mesh.n_data
        pgrads, off = {}, 0
        for k in names:
            size = params[k].numel()
            pgrads[k] = mean[off:off + size].reshape(params[k].shape)
            off += size
        return loss.detach(), rgb.detach(), image, out.spilled, pgrads, (
            meta, sink_grad, route, proj_local)

    def _statistics(self, state: StrategyState, meta, sink_grad, route,
                    proj_local) -> StrategyState:
        mesh, shard = self.mesh, self.shard
        scale = 0.5 * max(self.width, self.height)
        idx = meta.bins.tile_gauss.reshape(-1)
        msk = meta.bins.tile_mask.reshape(-1)
        g = torch.abs(sink_grad).reshape(-1, 2)
        if self.tile_sharded:
            # Per received slab row, then back to the source shard with
            # the reverse all-to-all: on this member, block b holds what
            # band owner b computed for the rows this member sent it.
            g = torch.where(msk[:, None], g, torch.zeros_like(g))
            n_slab = mesh.n_gauss * self.send_cap
            slab = segment_sum(spread_masked(idx, msk, n_slab), g, n_slab)
            back = exchange_rows(slab, mesh.group(GAUSS_AXIS))
            gid = route.slot_gid.reshape(-1).to(torch.int32)
            valid = route.slot_valid.reshape(-1)
            back = torch.where(valid[:, None], back, torch.zeros_like(back))
            guv = segment_sum(spread_masked(gid, valid, shard), back, shard)
            visible = proj_local.valid.to(torch.float32)
            radius = proj_local.radius.detach()
        else:
            # Every member rendered the whole image and differentiated 1/G
            # of its loss: the sink's gradient is G times smaller.
            g = torch.where(msk[:, None], g * mesh.n_gauss,
                            torch.zeros_like(g))
            c = self.capacity
            guv = segment_sum(spread_masked(idx, msk, c), g, c)
            g0 = mesh.gauss_idx * shard
            guv = guv[g0:g0 + shard]
            visible = meta.proj.valid[g0:g0 + shard].to(torch.float32)
            radius = meta.proj.radius[g0:g0 + shard]
        grad_ndc = torch.sqrt((guv[:, 0] * scale) ** 2
                              + (guv[:, 1] * scale) ** 2)
        data = mesh.group(DATA_AXIS)
        summed = all_reduce(torch.stack([grad_ndc, visible]), data)
        radii = all_reduce(radius / float(max(self.width, self.height)),
                           data, torch.distributed.ReduceOp.MAX)
        return StrategyState(
            grad_accum=state.grad_accum + summed[0],
            count=state.count + summed[1],
            max_radii=torch.maximum(state.max_radii, radii))

    def _metrics(self, loss, rgb, image, spilled) -> Dict[str, torch.Tensor]:
        data = self.mesh.group(DATA_AXIS)
        mean = all_reduce(torch.stack([loss, losses.psnr(rgb, image)]),
                          data) / self.mesh.n_data
        spilled = all_reduce(spilled.to(torch.int32), data,
                             torch.distributed.ReduceOp.MAX)
        return {"loss": mean[0], "psnr": mean[1], "spilled": spilled}

    # ------------------------------------------------------------ public
    def gradients(self, params, alive, cams, images, step_idx: int,
                  seed: int = 0):
        """(metrics, the gradients Adam would be fed): averaged over
        ``data``, dead rows zero; nothing is updated."""
        loss, rgb, image, spilled, pgrads, _ = self._forward_backward(
            params, alive, cams, images, step_idx, seed)
        return self._metrics(loss, rgb, image, spilled), pgrads

    def __call__(self, params, alive, strat_state: StrategyState,
                 cams: CameraBatch, images: torch.Tensor, step_idx: int,
                 seed: int = 0):
        """One step on this process's shard: ``params`` (leaf tensors of
        the optimizer) are updated in place.  Returns (params, the new
        statistics, metrics {loss, psnr: means over data; spilled: max})."""
        loss, rgb, image, spilled, pgrads, aux = self._forward_backward(
            params, alive, cams, images, step_idx, seed)
        for k, g in pgrads.items():
            params[k].grad = g
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            strat_state = self._statistics(strat_state, *aux)
        return params, strat_state, self._metrics(loss, rgb, image, spilled)


def make_sharded_train_step(
    mesh: Mesh,
    optimizer,
    model_config: rade_gs.RadeGSConfig,
    width: int,
    height: int,
    capacity: int,
    reg_active: bool = False,
    tile_sharded: bool = False,
    send_cap: Optional[int] = None,
) -> ShardedTrainStep:
    """Build the sharded train step of this process.

    Args:
        mesh: the (data, gauss) mesh of ``parallel/mesh.py::make_mesh``.
        optimizer: the (Adam, LambdaLR) pair of ``train/optim.py::
            make_optimizer`` over this process's shard of the parameters.
        model_config: the RaDe-GS configuration.
        width, height: the cameras' image size.
        capacity: the whole table's capacity C (a multiple of the
            ``gauss`` size).
        reg_active: the depth-normal phase.
        tile_sharded: route projected rows to per-member tile bands with
            one all-to-all (``parallel/tiles.py``) instead of gathering the
            whole set; the padded tile grid must split into G bands.
        send_cap: the routing slab's rows per (source, band); the shard
            size by default (nothing dropped).  Overflow drops the farthest
            Gaussians and counts them in ``spilled``.

    Returns:
        ``step(params, alive, strat_state, cams, images, step_idx, seed)
        -> (params, strat_state, metrics)`` on the local shards, with
        ``cams`` a :class:`CameraBatch` of exactly one camera per ``data``
        row (it raises otherwise) and ``images`` [B, H, W, 3].
    """
    return ShardedTrainStep(mesh, optimizer, model_config, width, height,
                            capacity, reg_active, tile_sharded, send_cap)


def make_sharded_refine_step(mesh: Mesh, strategy_cfg,
                             scene_scale: float = 1.0):
    """Sharded densify/prune.

    The JAX package runs the single-device ``strategy.refine`` under GSPMD
    on the sharded arrays; here every process gathers the parameters, the
    alive mask and the statistics over ``gauss``, runs the same
    ``strategy.refine`` with the same split noise (one generator seed on
    every process), keeps its own shard and zeroes its shard's Adam
    moments of the rows written.

    ``optimizer`` is the step's (Adam, LambdaLR) pair.  Returns
    ``refine(params, alive, optimizer, strat_state, seed,
    allow_split, scale_cull, screen_cull, allow_dup) -> (params, alive,
    strat_state, (n_dup, n_split, n_cull, dropped))``; ``params`` are
    updated in place.
    """

    def refine(params, alive, optimizer, strat_state, seed: int,
               allow_split: bool = True, scale_cull: bool = False,
               screen_cull: bool = False, allow_dup: bool = True):
        shard = alive.shape[0]
        g0 = mesh.gauss_idx * shard
        with torch.no_grad():
            full = {k: unshard(v.detach(), mesh) for k, v in params.items()}
            state = StrategyState(*(unshard(x, mesh) for x in strat_state))
            gen = torch.Generator(device=alive.device).manual_seed(seed)
            res = strategy.refine(
                full, unshard(alive.to(torch.bool), mesh), state,
                strategy_cfg, generator=gen, scene_scale=scene_scale,
                allow_split=allow_split, scale_cull=scale_cull,
                screen_size_cull=screen_cull, allow_dup=allow_dup)
            sl = slice(g0, g0 + shard)
            for k, v in params.items():
                v.copy_(res.params[k][sl])
        strategy.zero_opt_rows(optimizer[0], res.written[sl])
        return params, res.alive[sl], StrategyState(
            *(x[sl] for x in res.state)), (res.n_dup, res.n_split,
                                           res.n_cull, res.dropped)

    return refine

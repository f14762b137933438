"""Training engine: the train step and the refinement schedule.

Counterpart of the JAX package's ``train/trainer.py``.  One step renders a
camera, takes the loss and its backward (the rasterizer's screen-space sink
rides the same backward), zeroes the gradients of dead capacity rows,
skips the update when any gradient is not finite, and otherwise runs the
per-group Adam and accumulates the densification statistics (per window
slot, or per intersection with ``backend="pallas"``).  With per-camera
ground-truth feature maps it trains rade-features: the loss adds the
decoded latents' cosine distillation and the decoder is one more Adam
group.  Around the step, the host-side schedule of the reference: refine
every ``refine_every`` steps inside the densification window, reset
opacities periodically, depth-normal loss from
``regularization_from_iter``, capacity growth ahead of densification,
progressive resolution (``num_downscales``), and a checkpoint every
``steps_per_save`` steps through ``checkpoint_fn``.

The reference's remaining options: camera pose optimization (a 6-DoF
delta per training camera on the rendered camera, ``train/camera_opt.py``)
and per-image bilateral grids (on the rendered RGB, with a total-variation
term, ``train/bilateral.py``), each one more Adam group.  Datasets over
``dataset_hbm_budget_bytes`` stay in pinned host memory and stream the
selected frame (and its feature maps) to the card each step.  ``writers``
receive each step's metrics.  Evaluation reports PSNR and SSIM, and LPIPS
wherever its VGG16 weights are found (``utils/lpips.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.cameras import Camera
from ..features import decoder as decoder_lib
from ..models import rade_features, rade_gs
from ..models.gaussians import GaussianParams, grow_capacity, num_alive
from ..ops.rasterize import absgrad_sink_shape, pallas_sink_shape
from ..utils import lpips as lp
from ..utils.device import resolve_device
from . import bilateral
from . import camera_opt as co
from . import checkpoint as ckpt
from . import losses, optim, strategy

# The per-camera (not per-Gaussian) parameters of the two options, under
# the JAX package's parameter keys.
CAMERA_PARAM_GROUPS = {"camera_opt": co.CAMERA_OPT_GROUP,
                       "bilateral_grid": bilateral.BILATERAL_GROUP}


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The reference's training cadence and options; field names and
    defaults are the JAX package's.

    ``optimize_camera_poses`` adds the ``camera_opt`` group (a 6-DoF pose
    delta per training camera), ``use_bilateral_grid`` the
    ``bilateral_grid`` group (a [8, 16, 16, 12] affine colour grid per
    training image, with ``10 *`` its total variation in the loss).
    Datasets whose images and feature maps (4 bytes a value) exceed
    ``dataset_hbm_budget_bytes`` stay in pinned host memory and stream one
    frame per step.
    """

    max_iterations: int = 30000
    steps_per_eval_image: int = 100
    steps_per_eval_all_images: int = 1000
    steps_per_save: int = 2000
    model: rade_gs.RadeGSConfig = rade_gs.RadeGSConfig()
    strategy: strategy.StrategyConfig = strategy.StrategyConfig()
    scene_scale: float = 1.0
    capacity_headroom: float = 1.5   # grow arrays when occupancy * this > C
    seed: int = 42
    optimize_camera_poses: bool = False
    use_bilateral_grid: bool = False
    # Progressive resolution (Splatfacto): train at 1/2^k of the resolution
    # early, halving the factor every ``resolution_schedule`` steps.
    num_downscales: int = 0
    resolution_schedule: int = 3000
    dataset_hbm_budget_bytes: int = 4 << 30


def step_generator(seed: int, step: int, salt: int, device,
                   data_idx: int = 0) -> torch.Generator:
    """The random stream ``salt`` (1: background, 2: split noise) of one
    step, keyed by (seed, step) and, in the sharded step, by the ``data``
    row as ``fold_in(key, data_idx)`` keys it; row 0 is the
    single-device trainer's stream."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + 4 * step + salt + (data_idx << 40)) % (1 << 62))


def _move_camera(cam: Camera, device) -> Camera:
    return dataclasses.replace(cam, K=cam.K.to(device),
                               c2w=cam.c2w.to(device))


def _image(im, device) -> torch.Tensor:
    """A float32 image or feature map (numpy array or tensor) on
    ``device``."""
    if isinstance(im, torch.Tensor):
        return im.detach().to(device, torch.float32)
    return torch.tensor(np.asarray(im, np.float32), device=device)


def _host_image(im, device) -> torch.Tensor:
    """A float32 image or feature map kept on the host for streaming to
    ``device``: pinned when that is a card, so each step's copy can be
    asynchronous."""
    t = _image(im, "cpu")
    return t.pin_memory() if device.type == "cuda" else t


def _nbytes(x) -> int:
    """Bytes of ``x`` at 4 bytes a value, as the JAX trainer counts."""
    return int(np.prod(x.shape)) * 4


class Trainer:
    """Single-card trainer over a full-image dataset.

    ``params`` are the raw parameter tensors at capacity C and ``alive`` the
    [C] bool mask; the trainer keeps its own leaf copies on ``device`` (the
    card by default).  Refinement, opacity reset and capacity growth update
    them in place, so the optimizer keeps its parameters.

    rade-features: ``features`` holds each camera's ground-truth maps
    {branch: [C, h, w]} (``config.model`` a ``RadeFeaturesConfig`` whose
    ``feature_dims`` they match) and ``decoder`` the decoder, which the
    trainer moves to ``device`` and updates in place.  ``checkpoint_fn``
    is called with the trainer every ``steps_per_save`` steps of
    :meth:`train` (for example ``lambda t: t.save(directory)``).

    The options' per-camera parameters live in ``camera_params``
    (``"camera_opt"`` [num_cameras, 6], ``"bilateral_grid"``
    [num_cameras, 8, 16, 16, 12]); ``params`` may carry them in, as the
    JAX trainer's parameter dict does, and they start at the identity
    otherwise.  ``writers`` (``utils/writers.py``) get each step's
    metrics.
    """

    def __init__(
        self,
        config: TrainerConfig,
        cameras: Sequence[Camera],
        images: Sequence,
        params: GaussianParams,
        alive: torch.Tensor,
        groups: Optional[Dict[str, optim.GroupSpec]] = None,
        checkpoint_fn: Optional[Callable] = None,
        features: Optional[Sequence[Dict]] = None,
        decoder: Optional[decoder_lib.TwoLayerDecoder] = None,
        device=None,
        writers: Optional[Sequence] = None,
    ):
        if len(cameras) != len(images):
            raise ValueError(f"{len(cameras)} cameras but {len(images)} "
                             "images")
        if (features is None) != (decoder is None):
            raise ValueError("features and decoder come together")
        dev = resolve_device(device)
        self.device = dev
        self.config = config
        self.cameras = [_move_camera(c, dev) for c in cameras]
        # The dataset stays on the card while it fits the budget; past it,
        # frames and feature maps stay in pinned host memory and each step
        # copies the selected one over (train_one_step).
        total = sum(_nbytes(im) for im in images)
        if features is not None:
            total += sum(_nbytes(v) for f in features for v in f.values())
        self.streaming = total > config.dataset_hbm_budget_bytes
        keep = _host_image if self.streaming else _image
        self.images = [keep(im, dev) for im in images]
        self.features = None
        if features is not None:
            self.features = [{k: keep(v, dev) for k, v in f.items()}
                             for f in features]
            _check_features(config.model, self.features, len(cameras))
        self.decoder = decoder.to(dev) if decoder is not None else None

        def leaf(v):
            return v.detach().to(dev, torch.float32).clone().requires_grad_(
                True)

        self.params = {k: leaf(v) for k, v in params.items()
                       if k not in CAMERA_PARAM_GROUPS}
        self.camera_params = {k: leaf(v) for k, v in params.items()
                              if k in CAMERA_PARAM_GROUPS}
        if config.optimize_camera_poses and \
                "camera_opt" not in self.camera_params:
            self.camera_params["camera_opt"] = leaf(
                co.init_camera_opt(len(cameras), dev))
        if config.use_bilateral_grid and \
                "bilateral_grid" not in self.camera_params:
            self.camera_params["bilateral_grid"] = leaf(
                bilateral.init_bilateral_grids(len(cameras), device=dev))
        self.alive = alive.to(dev, torch.bool)
        self.groups = dict(groups or (
            optim.RADE_FEATURES_GROUPS if "distill_features" in params
            else optim.RADE_GS_GROUPS))
        for k in self.camera_params:
            self.groups.setdefault(k, CAMERA_PARAM_GROUPS[k])
        self.optimizer, self.scheduler = optim.make_optimizer(
            self._opt_params(), self.groups)
        self.strat_state = strategy.init_state(self.alive.shape[0], dev)
        self.step = 0
        self.checkpoint_fn = checkpoint_fn
        self.writers = list(writers or [])
        self.history: List[Dict[str, float]] = []

    def _opt_params(self) -> Dict:
        """The optimizer's groups: one per parameter (per-camera ones
        included), and the decoder's tensors as one group."""
        out = {**self.params, **self.camera_params}
        if self.decoder is not None:
            out["decoder"] = list(self.decoder.parameters())
        return out

    def _generator(self, salt: int) -> torch.Generator:
        """The step's random stream ``salt`` (1: background, 2: split
        noise), keyed by (seed, step) so a repeated or resumed step draws
        the same numbers.  It lives on the trainer's device, so the draws
        are made where they are used."""
        return step_generator(self.config.seed, self.step, salt, self.device)

    # ----------------------------------------------------------- the step
    def _train_step(self, camera: Camera, image: torch.Tensor,
                    features_gt: Optional[Dict[str, torch.Tensor]],
                    reg_active: bool, downscale: int = 1,
                    cam_idx: int = 0) -> Dict[str, torch.Tensor]:
        cfg = self.config.model
        params, alive, cparams = self.params, self.alive, self.camera_params
        if downscale > 1:
            # ``camera`` comes downscaled (floor-division sizes); the
            # ground truth is box-filtered to match, as Splatfacto does.
            h, w = camera.height, camera.width
            image = image[:h * downscale, :w * downscale].reshape(
                h, downscale, w, downscale, -1).mean(dim=(1, 3))
        cap = alive.shape[0]
        pallas = cfg.render.backend == "pallas"
        sink_shape = pallas_sink_shape if pallas else absgrad_sink_shape
        sink = torch.zeros(sink_shape(camera.width, camera.height, cap,
                                      cfg.render),
                           device=self.device, requires_grad=True)
        if "camera_opt" in cparams:
            camera = co.apply_pose_adjustment(
                camera, cparams["camera_opt"][cam_idx])
        outputs, meta = rade_gs.get_outputs(
            params, alive, camera, self.step, cfg,
            generator=self._generator(1), training=True,
            compute_error_maps=reg_active, absgrad_sink=sink)
        if "bilateral_grid" in cparams:
            outputs = dict(outputs)
            outputs["rgb"] = bilateral.apply_bilateral_grid(
                cparams["bilateral_grid"][cam_idx], outputs["rgb"])
        if features_gt is not None:
            loss, ldict = rade_features.get_loss(
                outputs, image, features_gt, params, self.decoder, alive,
                self.step, cfg, reg_active=reg_active)
            dparams = list(self.decoder.parameters())
        else:
            loss, ldict = rade_gs.get_loss(outputs, image, params, alive,
                                           self.step, cfg,
                                           reg_active=reg_active)
            dparams = []
        if "bilateral_grid" in cparams:
            ldict["tv_loss"] = 10.0 * bilateral.total_variation_loss(
                cparams["bilateral_grid"])
            loss = loss + ldict["tv_loss"]
        names = list(params)
        cnames = list(cparams)
        grads = torch.autograd.grad(
            loss, [params[k] for k in names]
            + [cparams[k] for k in cnames] + dparams + [sink],
            allow_unused=True)
        sink_grad = grads[-1]
        nparams = len(names) + len(cnames)

        # Dead rows must not move: zero their gradients exactly.
        amask = alive.to(torch.float32)
        pgrads = {}
        for k, g in zip(names, grads[:len(names)]):
            g = torch.zeros_like(params[k]) if g is None else g
            pgrads[k] = g * amask.reshape((-1,) + (1,) * (g.dim() - 1))
        for k, g in zip(cnames, grads[len(names):nparams]):
            pgrads[k] = torch.zeros_like(cparams[k]) if g is None else g
        dgrads = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(dparams, grads[nparams:-1])]

        # Non-finite guard: one degenerate splat's inf/NaN gradient would
        # poison every Adam moment, so such a step is skipped (parameters,
        # decoder, optimizer and statistics keep their values) and counted.
        # Taking the decision costs one host read of this flag per step.
        finite = torch.stack([
            torch.isfinite(g).all()
            for g in [*pgrads.values(), *dgrads, sink_grad]]).all()
        if bool(finite):
            for k, g in pgrads.items():
                (params[k] if k in params else cparams[k]).grad = g
            for p, g in zip(dparams, dgrads):
                p.grad = g
            self.optimizer.step()
            self.scheduler.step()
            self.optimizer.zero_grad(set_to_none=True)
            update = strategy.update_state_from_isect if pallas \
                else strategy.update_state
            self.strat_state = update(self.strat_state, meta, sink_grad)
        rgb = outputs["rgb"].detach()
        return {
            "nonfinite_grad": (~finite).to(torch.float32),
            "loss": loss.detach(),
            "psnr": losses.psnr(rgb, image),
            "spilled": outputs["spilled"].to(torch.float32),
            "num_gaussians": num_alive(alive).to(torch.float32),
            **{k: v.detach() for k, v in ldict.items()},
        }

    # --------------------------------------------------------------- host
    def downscale_factor(self, step: Optional[int] = None) -> int:
        """Progressive-resolution factor at ``step`` (the trainer's step by
        default): 2^max(num_downscales - step // resolution_schedule, 0).
        Evaluation always renders at full resolution."""
        cfg = self.config
        if cfg.num_downscales <= 0:
            return 1
        s = self.step if step is None else step
        return 2 ** max(
            cfg.num_downscales - s // max(cfg.resolution_schedule, 1), 0)

    def train_one_step(self) -> Dict[str, float]:
        cfg = self.config
        scfg = cfg.strategy
        # Host-side, step-keyed camera draw, as the JAX trainer draws it.
        idx = int(np.random.RandomState(cfg.seed * 9973 + self.step).randint(
            len(self.cameras)))
        reg_active = (cfg.model.use_depth_normal_loss
                      and self.step >= cfg.model.regularization_from_iter)
        d = self.downscale_factor()
        image = self.images[idx]
        features_gt = self.features[idx] if self.features is not None \
            else None
        if self.streaming:
            # The selected frame's copy, queued on the step's stream.
            image = image.to(self.device, non_blocking=True)
            if features_gt is not None:
                features_gt = {k: v.to(self.device, non_blocking=True)
                               for k, v in features_gt.items()}
        metrics = self._train_step(self.cameras[idx].downscaled(d), image,
                                   features_gt, reg_active, d, idx)
        self.step += 1

        refined = {}
        if scfg.is_refine_step(self.step) and self.step < cfg.max_iterations:
            densify = scfg.densify_active(self.step, len(self.cameras))
            cull_only = (not scfg.splits_allowed(self.step)
                         and scfg.continue_cull_post_densification)
            if densify or cull_only:
                self._maybe_grow_capacity()
                res = strategy.refine(
                    self.params, self.alive, self.strat_state, scfg,
                    generator=self._generator(2),
                    scene_scale=cfg.scene_scale, allow_split=densify,
                    allow_dup=densify,
                    scale_cull=scfg.scale_cull_active(self.step),
                    screen_size_cull=scfg.screen_size_active(self.step))
                self._assign(res.params)
                self.alive = res.alive
                strategy.zero_opt_rows(self.optimizer, res.written)
                self.strat_state = res.state
                refined = {"refine_dup": res.n_dup, "refine_split":
                           res.n_split, "refine_cull": res.n_cull,
                           "refine_dropped": res.dropped}
        if scfg.is_reset_step(self.step):
            self._assign(strategy.reset_opacity(self.params, scfg))
            # Zero the opacity moments, else momentum undoes the clamp.
            optim.zero_group_moments(self.optimizer, "opacities")

        # One device -> host transfer for the whole metrics dict.
        keys = list(metrics)
        values = torch.stack([metrics[k].reshape(()) for k in keys]).tolist()
        out = dict(zip(keys, values))
        out["num_gaussians"] = int(out["num_gaussians"])
        out.update({k: int(v) for k, v in refined.items()})
        self.history.append(out)
        return out

    @torch.no_grad()
    def _assign(self, new_params: GaussianParams) -> None:
        """Write new parameter values into the leaf tensors, in place."""
        for k, v in new_params.items():
            if v is not self.params[k]:
                self.params[k].copy_(v)

    def _maybe_grow_capacity(self) -> None:
        c = self.alive.shape[0]
        n = int(num_alive(self.alive))
        if n * self.config.capacity_headroom <= c:
            return
        new_c = 2 * c
        grown, self.alive = grow_capacity(
            {k: v.detach() for k, v in self.params.items()}, self.alive,
            new_c)
        self.params = {k: v.requires_grad_(True) for k, v in grown.items()}
        # Surviving rows keep their Adam moments; new rows start at zero.
        optim.graft_opt_state(self.optimizer, self.params)

        def pad(x):
            out = torch.zeros(new_c, dtype=x.dtype, device=x.device)
            out[:c] = x
            return out

        self.strat_state = strategy.StrategyState(
            *(pad(x) for x in self.strat_state))

    def train(
        self,
        num_steps: Optional[int] = None,
        log_every: int = 100,
        log_fn: Callable = print,
        eval_cameras: Optional[Sequence[Camera]] = None,
        eval_images: Optional[Sequence] = None,
    ) -> List[Dict[str, float]]:
        """Run the training loop; with eval data, one eval image every
        ``steps_per_eval_image`` steps and the full set every
        ``steps_per_eval_all_images`` (``eval_psnr`` / ``eval_all_psnr`` in
        ``self.history``); ``checkpoint_fn`` every ``steps_per_save``
        steps."""
        if num_steps is None:
            num_steps = self.config.max_iterations
        do_eval = eval_cameras is not None and len(eval_cameras) > 0
        t0 = time.time()
        for _ in range(num_steps):
            m = self.train_one_step()
            if do_eval and self.step % self.config.steps_per_eval_image == 0:
                i = (self.step // self.config.steps_per_eval_image) % len(
                    eval_cameras)
                ev = self.eval_image(eval_cameras[i], eval_images[i])
                self.history[-1]["eval_psnr"] = ev["psnr"]
                self.history[-1]["eval_ssim"] = ev["ssim"]
                if "lpips" in ev:
                    self.history[-1]["eval_lpips"] = ev["lpips"]
            if do_eval and \
                    self.step % self.config.steps_per_eval_all_images == 0:
                evs = [self.eval_image(c, im)
                       for c, im in zip(eval_cameras, eval_images)]
                self.history[-1]["eval_all_psnr"] = float(
                    np.mean([e["psnr"] for e in evs]))
                log_fn(f"step {self.step:6d}  eval-all psnr "
                       f"{self.history[-1]['eval_all_psnr']:.2f}")
            for w in self.writers:
                w.write(self.step, self.history[-1])
            if self.step % log_every == 0:
                rate = self.step / max(time.time() - t0, 1e-9)
                log_fn(f"step {self.step:6d}  loss {m['loss']:.4f}  "
                       f"psnr {m['psnr']:.2f}  N {m['num_gaussians']}  "
                       f"{rate:.1f} it/s")
            if self.checkpoint_fn and \
                    self.step % self.config.steps_per_save == 0:
                self.checkpoint_fn(self)
        return self.history

    @torch.no_grad()
    def eval_image(self, camera: Camera, image) -> Dict[str, float]:
        outputs, _ = rade_gs.get_outputs(
            self.params, self.alive, _move_camera(camera, self.device),
            self.step, self.config.model, training=False)
        image = _image(image, self.device)
        metrics = {"psnr": float(losses.psnr(outputs["rgb"], image)),
                   "ssim": float(losses.ssim(outputs["rgb"], image))}
        if lp.lpips_available():
            metrics["lpips"] = lp.lpips(outputs["rgb"], image)
        return metrics

    # ------------------------------------------------------------- state
    def state(self) -> Dict:
        """A copy of everything a step reads and writes: parameters and
        decoder, optimizer and schedule, statistics, alive mask and step
        count.  :meth:`load_state` puts it back, so a step can be
        repeated."""
        return {
            "params": {k: v.detach().clone() for k, v in self.params.items()},
            "camera_params": {k: v.detach().clone()
                              for k, v in self.camera_params.items()},
            "decoder": None if self.decoder is None else {
                k: v.detach().clone() for k, v in
                decoder_lib.decoder_tensors(self.decoder).items()},
            "optimizer": copy.deepcopy(self.optimizer.state_dict()),
            "scheduler": copy.deepcopy(self.scheduler.state_dict()),
            "strat_state": strategy.StrategyState(
                *(x.clone() for x in self.strat_state)),
            "alive": self.alive.clone(),
            "step": self.step,
        }

    def load_state(self, state: Mapping) -> None:
        """Take back a :meth:`state` of this trainer, also across a
        capacity change: the parameters become new leaf tensors and the
        optimizer's groups are pointed at them."""
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in state["params"].items()}
        self.camera_params = {k: v.clone().requires_grad_(True)
                              for k, v in state["camera_params"].items()}
        leaves = {**self.params, **self.camera_params}
        if self.decoder is not None:
            with torch.no_grad():
                for k, v in decoder_lib.decoder_tensors(
                        self.decoder).items():
                    v.copy_(state["decoder"][k])
        for group in self.optimizer.param_groups:
            if group["name"] in leaves:
                group["params"][0] = leaves[group["name"]]
        # load_state_dict keeps the tensors it is given: hand it copies.
        self.optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))
        self.scheduler.load_state_dict(copy.deepcopy(state["scheduler"]))
        self.strat_state = strategy.StrategyState(
            *(x.clone() for x in state["strat_state"]))
        self.alive = state["alive"].clone()
        self.step = state["step"]

    def load_state_numpy(self, flat: Mapping[str, np.ndarray]) -> None:
        """Take over the JAX trainer's optimizer and strategy state.

        ``flat`` holds numpy arrays under the keys of the JAX package's
        checkpoints (``train/checkpoint.py``: ``"opt/"`` or ``"strat/"``
        followed by ``_flatten``'s key path): per group its Adam ``mu``,
        ``nu`` and update ``count`` (the decoder's moments in JAX's [in,
        out] layout), and ``grad_accum``, ``count`` and ``max_radii``.  The
        schedules continue from the count.
        """
        ckpt.load_optimizer_flat(self.optimizer, self.scheduler, flat,
                                 self.decoder)
        self.strat_state = ckpt.strategy_from_flat(
            flat, self.alive.shape[0], self.device)

    def save(self, directory, metadata: Optional[Dict] = None):
        """Write a resumable checkpoint (parameters, the options' per-camera
        parameters, decoder, alive mask, Adam state, statistics) to
        ``directory`` in the JAX package's format, with ``metadata`` in its
        sidecar beside the capacity; returns its path."""
        return ckpt.save_checkpoint(
            directory, self.step, {**self.params, **self.camera_params},
            self.alive, decoder=self.decoder, optimizer=self.optimizer,
            strat_state=self.strat_state,
            metadata={"capacity": int(self.alive.shape[0]),
                      **(metadata or {})})

    def restore(self, path) -> None:
        """Resume from a checkpoint of :meth:`save` or of the JAX
        trainer's ``save``: parameters, decoder and alive mask exactly, the
        Adam moments leaf by leaf where their shapes match, the update
        count and with it the schedules' position, the statistics and the
        step.  A kill between two saves and a resume from the last one
        continue the run bit for bit."""
        step, params, alive, extras = ckpt.load_checkpoint(path, self.device)
        self.step = step
        self.params = {k: v.to(torch.float32).requires_grad_(True)
                       for k, v in params.items()
                       if k not in CAMERA_PARAM_GROUPS}
        self.camera_params = {k: v.to(torch.float32).requires_grad_(True)
                              for k, v in params.items()
                              if k in CAMERA_PARAM_GROUPS}
        for k in self.camera_params:
            self.groups.setdefault(k, CAMERA_PARAM_GROUPS[k])
        self.alive = alive.to(torch.bool)
        if self.decoder is not None:
            decoder_lib.load_numpy(self.decoder, ckpt.decoder_arrays(extras))
        self.optimizer, self.scheduler = optim.make_optimizer(
            self._opt_params(), self.groups)
        self.load_state_numpy(extras)


def _check_features(model, features: List[Dict[str, torch.Tensor]],
                    n_cameras: int) -> None:
    """Features need a rade-features model, one map set per camera, and the
    model's ``feature_dims`` as their branches and shapes."""
    if not isinstance(model, rade_features.RadeFeaturesConfig):
        raise ValueError("features need a RadeFeaturesConfig model")
    if len(features) != n_cameras:
        raise ValueError(f"{n_cameras} cameras but {len(features)} feature "
                         "sets")
    dims = model.feature_dims_dict()
    for f in features:
        got = {k: tuple(v.shape) for k, v in f.items()}
        if got != {k: tuple(d) for k, d in dims.items()}:
            raise ValueError(f"feature maps {got} do not match the model's "
                             f"feature_dims {dims}")

"""The port's ``Trainer`` against the JAX package's, on the CPU.

On ``tests/test_training.py::_make_scene``'s scene (400 Gaussians, 64x64,
six orbit cameras, targets rendered by the JAX model) both trainers start
from one perturbed table and take the same steps (the camera draw is keyed
by the step in both, the background is black).  Their first five losses
agree within rtol 1e-3: whole trajectories are compared by metrics, not
bits, because Adam normalizes each gradient and so amplifies rounding
where a gradient is near zero.  The port's trainer also takes over the JAX
trainer's state mid-run (``Trainer.load_state_numpy``) and continues it,
and on its own raises PSNR by at least 3 dB in 200 steps, as
test_training.py asks of JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.models.gaussians import pad_to_capacity as jpad
from collab_splats_tpu.train import strategy as jstrategy
from collab_splats_tpu.train.checkpoint import _flatten
from collab_splats_tpu.train.trainer import Trainer as JTrainer
from collab_splats_tpu.train.trainer import TrainerConfig as JConfig
from collab_splats_tpu_torch.core.cameras import camera_from_numpy
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.models import rade_gs as trade
from collab_splats_tpu_torch.models.gaussians import params_from_numpy
from collab_splats_tpu_torch.train import strategy as tstrategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_training import _make_scene

torch.set_num_threads(2)
CAP = 512
NO_REFINE = 10_000_000


@pytest.fixture(scope="module")
def scene():
    gt, cams, images, cfg = _make_scene()
    init = dict(gt)
    init["means"] = gt["means"] + 0.02 * jax.random.normal(
        jax.random.PRNGKey(7), gt["means"].shape)
    init["features_dc"] = jnp.zeros_like(gt["features_dc"])
    init = {k: np.asarray(v) for k, v in jpad(init, CAP).items()}
    alive = np.arange(CAP) < gt["means"].shape[0]
    tcams = [camera_from_numpy(np.asarray(c.K), np.asarray(c.c2w), c.width,
                               c.height, device="cpu") for c in cams]
    tcfg = trade.RadeGSConfig(
        sh_degree=0, background="black",
        render=TOpts(tile_capacity=256, max_intersections=1 << 15),
        use_depth_normal_loss=False)
    return init, alive, cams, tcams, images, cfg, tcfg


def port_trainer(scene, max_iterations=200):
    init, alive, _, tcams, images, _, tcfg = scene
    conf = TrainerConfig(
        model=tcfg, max_iterations=max_iterations,
        strategy=tstrategy.StrategyConfig(warmup_length=NO_REFINE))
    return Trainer(conf, tcams, images, params_from_numpy(init, device="cpu"),
                   torch.from_numpy(alive), device="cpu")


@pytest.fixture(scope="module")
def jax_run(scene):
    """Five JAX steps, with the trainer's state after the second."""
    init, alive, cams, _, images, cfg, _ = scene
    tr = JTrainer(JConfig(model=cfg, max_iterations=200,
                          strategy=jstrategy.StrategyConfig(
                              warmup_length=NO_REFINE)),
                  cams, images, {k: jnp.asarray(v) for k, v in init.items()},
                  jnp.asarray(alive))
    losses = [tr.train_one_step()["loss"] for _ in range(2)]
    snapshot = ({k: np.asarray(v) for k, v in tr.params.items()},
                {**{f"opt/{k}": v for k, v in _flatten(tr.opt_state).items()},
                 **{f"strat/{k}": v
                    for k, v in _flatten(tr.strat_state).items()}})
    losses += [tr.train_one_step()["loss"] for _ in range(3)]
    return losses, snapshot


def test_first_five_losses_match_jax(scene, jax_run):
    tr = port_trainer(scene)
    losses = [tr.train_one_step()["loss"] for _ in range(5)]
    np.testing.assert_allclose(losses, jax_run[0], rtol=1e-3)
    assert all(h["nonfinite_grad"] == 0 for h in tr.history)


def test_continues_from_the_jax_trainers_state(scene, jax_run):
    losses, (params, flat) = jax_run
    init, alive, _, tcams, images, _, tcfg = scene
    tr = port_trainer((params,) + scene[1:])
    tr.load_state_numpy(flat)
    tr.step = 2
    got = [tr.train_one_step()["loss"] for _ in range(3)]
    np.testing.assert_allclose(got, losses[2:], rtol=1e-3)
    st = tr.optimizer.state[tr.params["means"]]
    assert float(st["step"]) == 5.0
    assert float(tr.strat_state.count.max()) == 5.0


def test_state_round_trip_repeats_a_step(scene):
    """A step taken again from ``Trainer.state()`` gives the same bits."""
    tr = port_trainer(scene)
    tr.train_one_step()
    saved = tr.state()

    def run():
        loss = tr.train_one_step()["loss"]
        opt = tr.optimizer.state[tr.params["means"]]
        return (loss, {k: v.detach().clone() for k, v in tr.params.items()},
                opt["exp_avg"].clone(), float(opt["step"]), tr.step,
                [x.clone() for x in tr.strat_state],
                tr.optimizer.param_groups[0]["lr"])

    a = run()
    tr.load_state(saved)
    b = run()
    assert a[0] == b[0] and a[3:5] == b[3:5] and a[6] == b[6]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    assert torch.equal(a[2], b[2])
    assert all(torch.equal(x, y) for x, y in zip(a[5], b[5]))
    assert float(saved["optimizer"]["state"][0]["step"]) == 1.0


def test_psnr_improves_in_200_steps(scene):
    _, _, _, tcams, images, _, _ = scene
    tr = port_trainer(scene)
    first = tr.train_one_step()
    for _ in range(199):
        m = tr.train_one_step()
    ev = tr.eval_image(tcams[0], images[0])
    assert ev["psnr"] > first["psnr"] + 3.0, (first["psnr"], ev["psnr"])
    assert np.isfinite(m["loss"]) and m["nonfinite_grad"] == 0
    # Dead capacity rows never move.
    dead = ~tr.alive
    init = params_from_numpy(scene[0], device="cpu")
    for k, v in tr.params.items():
        assert torch.equal(v.detach()[dead], init[k][dead]), k


def test_unported_options_raise(scene):
    """Both options that raised here before they were ported now build a
    trainer: its ``camera_opt`` and ``bilateral_grid`` groups exist, start
    at the identity and carry the JAX package's learning-rate tables."""
    from collab_splats_tpu.train.bilateral import BILATERAL_GROUP
    from collab_splats_tpu.train.camera_opt import CAMERA_OPT_GROUP

    init, alive, _, tcams, images, _, tcfg = scene
    conf = TrainerConfig(model=tcfg, optimize_camera_poses=True,
                         use_bilateral_grid=True)
    tr = Trainer(conf, tcams, images, params_from_numpy(init, device="cpu"),
                 torch.from_numpy(alive), device="cpu")
    n = len(tcams)
    assert tuple(tr.camera_params["camera_opt"].shape) == (n, 6)
    assert not tr.camera_params["camera_opt"].any()
    assert tuple(tr.camera_params["bilateral_grid"].shape) == (
        n, 8, 16, 16, 12)
    ident = torch.cat([torch.eye(3).reshape(-1), torch.zeros(3)])
    assert torch.equal(tr.camera_params["bilateral_grid"][2, 3, 4, 5],
                       ident)
    groups = {g["name"]: g for g in tr.optimizer.param_groups}
    for name, jspec in (("camera_opt", CAMERA_OPT_GROUP),
                        ("bilateral_grid", BILATERAL_GROUP)):
        spec = tr.groups[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec), name
        assert groups[name]["params"][0] is tr.camera_params[name]
        # The schedule starts at lr_pre_warmup = 0 (sine warmup).
        assert groups[name]["lr"] == 0.0, name

"""The trainer's remaining options against the JAX package's, on the CPU.

Numpy inputs from a seed go through the JAX function and the port's:

* ``exp_so3`` and ``apply_pose_adjustment`` within 1e-6;
* ``apply_bilateral_grid`` and ``total_variation_loss`` within 1e-6 (the
  sample positions bit-equal to ``jnp.linspace`` as XLA computes it), and
  the grid's gradient, which the port takes through dense contractions,
  within rtol 5e-4 and atol 5e-5 * max|g| (tests/test_pallas.py:205-206);
* one train step with poses and grids on, from the same carried-across
  parameters with noise injected into both groups (black background): the
  loss without its TV term within rtol 1e-5 (the TV term, a mean over
  73,728 grid differences, against its float64 value, see
  :func:`test_option_step_loss`), the two groups' gradients (Adam's first
  moment after the step, 0.1 * g in both packages) within the gradient
  tolerance, and their updates after a second step within it (plus one
  float32 ulp of the parameters);
* streaming: the port's trajectory at budget 0 equals its own at the
  default bit for bit, and the step comparison above runs both packages
  at budget 0, each streaming its frames from the host;
* LPIPS on synthetic VGG16 weights found through ``COLLAB_SPLATS_WEIGHTS``
  against JAX's ``_lpips_pair``, rtol 1e-4, and ``eval_image`` reporting
  ``lpips`` exactly when JAX's does;
* ``render_tiled_batch`` against JAX's within the tolerances of
  tests/test_render.py:261-270 (colour 5e-6, depth 1e-4);
* the writers (records, the event file's round trip, the crc32c known
  vectors), and the trainer writing every step;
* checkpoints with both groups, a JAX save resumed by the port and a port
  save resumed by JAX, parameters and moments equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.models import rade_gs as jrade
from collab_splats_tpu.ops import rasterize as jrast
from collab_splats_tpu.train import bilateral as jbil
from collab_splats_tpu.train import camera_opt as jco
from collab_splats_tpu.train import strategy as jstrategy
from collab_splats_tpu.train.checkpoint import _flatten
from collab_splats_tpu.train.trainer import Trainer as JTrainer
from collab_splats_tpu.train.trainer import TrainerConfig as JConfig
from collab_splats_tpu.utils import lpips as jlp
from collab_splats_tpu.utils import writers as jwriters
from collab_splats_tpu_torch.core.cameras import stack_cameras
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.data.synthetic import orbit_cameras
from collab_splats_tpu_torch.models import rade_gs as trade
from collab_splats_tpu_torch.models.gaussians import params_from_numpy
from collab_splats_tpu_torch.ops import rasterize as trast
from collab_splats_tpu_torch.train import bilateral as tbil
from collab_splats_tpu_torch.train import camera_opt as tco
from collab_splats_tpu_torch.train import checkpoint as tckpt
from collab_splats_tpu_torch.train import strategy as tstrategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig
from collab_splats_tpu_torch.utils import lpips as tlp
from collab_splats_tpu_torch.utils import writers as twriters
from test_torch_core import both_cameras, numpy_scene

torch.set_num_threads(2)
NO_REFINE = 10_000_000
CAP = 192


def assert_grad_close(a, b, name):
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5 * scale,
                               err_msg=name)


# ------------------------------------------------------------ camera_opt
@pytest.mark.parametrize("scale", [0.0, 1e-8, 0.3, 2.5],
                         ids=["zero", "tiny", "small", "large"])
def test_exp_so3(scale):
    omega = scale * np.random.default_rng(1).normal(size=3).astype(
        np.float32)
    got = tco.exp_so3(torch.from_numpy(omega)).numpy()
    want = np.asarray(jco.exp_so3(jnp.asarray(omega)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_apply_pose_adjustment():
    _, K, c2w = numpy_scene(4, seed=2)
    delta = (0.05 * np.random.default_rng(3).normal(size=6)).astype(
        np.float32)
    jcam, tcam = both_cameras(K, c2w, 64, 48)
    got = tco.apply_pose_adjustment(tcam, torch.from_numpy(delta))
    want = jco.apply_pose_adjustment(jcam, jnp.asarray(delta))
    np.testing.assert_allclose(got.c2w.numpy(), np.asarray(want.c2w),
                               atol=1e-6)
    assert torch.equal(got.K, tcam.K)


# ------------------------------------------------------------ bilateral
@pytest.mark.parametrize("n", [2, 40, 48, 63, 64, 720, 1280])
def test_sample_positions_match_linspace(n):
    for stop in (15.0, 7.0):
        want = np.asarray(jax.jit(lambda: jnp.linspace(0.0, stop, n))())
        np.testing.assert_array_equal(
            tbil.sample_positions(stop, n).numpy(), want)


def noisy_grids(n, seed):
    g = np.asarray(jbil.init_bilateral_grids(n))
    return (g + 0.05 * np.random.default_rng(seed).normal(
        size=g.shape)).astype(np.float32)


@pytest.mark.parametrize("hw", [(40, 48), (64, 64)])
def test_bilateral_forward_and_grad(hw):
    h, w = hw
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    grids = noisy_grids(2, 5)
    ct = rng.normal(size=(h, w, 3)).astype(np.float32)

    def jloss(g):
        out = jbil.apply_bilateral_grid(g[1], jnp.asarray(rgb))
        return jnp.sum(out * ct) + jbil.total_variation_loss(g), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(grids))
    tg = torch.tensor(grids, requires_grad=True)
    tout = tbil.apply_bilateral_grid(tg[1], torch.from_numpy(rgb))
    tv = tbil.total_variation_loss(tg)
    tl = torch.sum(tout * torch.from_numpy(ct)) + tv
    (grad,) = torch.autograd.grad(tl, tg)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    np.testing.assert_allclose(float(tv.detach()), float(
        jbil.total_variation_loss(
        jnp.asarray(grids))), rtol=1e-6, atol=1e-6)
    assert_grad_close(grad.numpy(), np.asarray(jg), "bilateral grid")
    ident = tbil.init_bilateral_grids(1, device="cpu")
    np.testing.assert_array_equal(ident.numpy(),
                                  np.asarray(jbil.init_bilateral_grids(1)))


# ------------------------------------------------------- the train step
@pytest.fixture(scope="module")
def options_scene():
    """150 numpy Gaussians padded to 192, three 48x48 orbit cameras, and
    targets rendered from a shifted copy of the scene (so the fit has work
    to do), all handed to both packages."""
    p, _, _ = numpy_scene(150, seed=12, width=48, height=48)
    init = {k: np.concatenate([v, np.zeros((CAP - 150,) + v.shape[1:],
                                           np.float32)])
            for k, v in p.items()}
    alive = np.arange(CAP) < 150
    kw = dict(sh_degree=0, background="black", use_depth_normal_loss=False)
    cfg = jrade.RadeGSConfig(render=jrast.RenderOptions(
        tile_capacity=256, max_intersections=1 << 15), **kw)
    tcfg = trade.RadeGSConfig(render=TOpts(
        tile_capacity=256, max_intersections=1 << 15), **kw)
    orbit = orbit_cameras(3, radius=3.0, width=48, height=48, focal=53.0,
                          device="cpu")
    cams, tcams = zip(*(both_cameras(c.K.numpy(), c.c2w.numpy(), 48, 48)
                        for c in orbit))
    target = params_from_numpy(p, device="cpu")
    target["means"] = target["means"] + 0.03
    with torch.no_grad():
        images = [trade.get_outputs(target, torch.ones(150, dtype=bool), c,
                                    0, tcfg, training=False)[0]["rgb"]
                  .numpy() for c in tcams]
    rng = np.random.default_rng(6)
    extra = {"camera_opt": (0.01 * rng.normal(size=(3, 6))).astype(
                 np.float32),
             "bilateral_grid": noisy_grids(3, 7)}
    return init, alive, list(cams), list(tcams), images, cfg, tcfg, extra


def option_configs(scene, budget=4 << 30, steps=20):
    _, _, _, _, _, cfg, tcfg, _ = scene
    kw = dict(max_iterations=steps, optimize_camera_poses=True,
              use_bilateral_grid=True, dataset_hbm_budget_bytes=budget)
    return (JConfig(model=cfg, strategy=jstrategy.StrategyConfig(
                warmup_length=NO_REFINE), **kw),
            TrainerConfig(model=tcfg, strategy=tstrategy.StrategyConfig(
                warmup_length=NO_REFINE), **kw))


def port_options_trainer(scene, budget=4 << 30, **kw):
    init, alive, _, tcams, images, _, _, extra = scene
    params = {**params_from_numpy(init, device="cpu"),
              **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return Trainer(option_configs(scene, budget)[1], tcams, images, params,
                   torch.from_numpy(alive), device="cpu", **kw)


def jax_options_trainer(scene, budget=4 << 30):
    init, alive, cams, _, images, _, _, extra = scene
    tr = JTrainer(option_configs(scene, budget)[0], cams, images,
                  {k: jnp.asarray(v) for k, v in init.items()},
                  jnp.asarray(alive))
    tr.params = {**tr.params,
                 **{k: jnp.asarray(v) for k, v in extra.items()}}
    return tr


def moments(flat, group):
    pre = f"opt/.inner_states/['{group}']/.inner_state/[0]/"
    return flat[f"{pre}.mu/['{group}']"], flat[f"{pre}.nu/['{group}']"]


@pytest.fixture(scope="module")
def option_steps(options_scene):
    """Two steps of each package's trainer with both options on, with each
    trainer's Adam state after the first."""
    jtr = jax_options_trainer(options_scene, budget=0)
    ttr = port_options_trainer(options_scene, budget=0)
    out = {"jax": [], "port": [],
           "streaming": (isinstance(jtr.images[0], np.ndarray),
                         ttr.streaming)}
    for _ in range(2):
        jm = jtr.train_one_step()
        tm = ttr.train_one_step()
        jflat = {f"opt/{k}": v for k, v in _flatten(jtr.opt_state).items()}
        # Copies: on the CPU the flat arrays share the moments' memory.
        tflat = {k: np.array(v) for k, v in
                 tckpt.optimizer_to_flat(ttr.optimizer).items()}
        out["jax"].append((jm, jflat, {k: np.asarray(jtr.params[k])
                                       for k in options_scene[7]}))
        out["port"].append((tm, tflat, {
            k: v.detach().numpy().copy()
            for k, v in ttr.camera_params.items()}))
    return out


def test_option_step_loss(option_steps, options_scene):
    """The loss without its TV term within rtol 1e-5.  The TV term is
    held to its float64 value: XLA's float32 mean over the grids' 73,728
    differences on the CPU lands 1.1e-5 (relative) off it, the port's
    within 1e-6, so against JAX it is held within rtol 2e-5."""
    grids = options_scene[7]["bilateral_grid"].astype(np.float64)
    tv64 = 10.0 * sum(np.mean(np.diff(grids, axis=a) ** 2)
                      for a in (1, 2, 3))
    (jm, _, _), (tm, _, _) = option_steps["jax"][0], option_steps["port"][0]
    np.testing.assert_allclose(tm["tv_loss"], tv64, rtol=1e-6)
    for (jm, _, _), (tm, _, _) in zip(option_steps["jax"],
                                      option_steps["port"]):
        np.testing.assert_allclose(tm["loss"] - tm["tv_loss"],
                                   jm["loss"] - jm["tv_loss"], rtol=1e-5)
        np.testing.assert_allclose(tm["tv_loss"], jm["tv_loss"], rtol=2e-5)
        assert tm["nonfinite_grad"] == 0


@pytest.mark.parametrize("group", ["camera_opt", "bilateral_grid"])
def test_option_step_gradients_and_updates(option_steps, options_scene,
                                           group):
    (_, jflat, _), (_, tflat, _) = option_steps["jax"][0], \
        option_steps["port"][0]
    jmu, _ = moments(jflat, group)
    tmu, _ = moments(tflat, group)
    assert np.abs(jmu).max() > 0
    assert_grad_close(tmu, jmu, f"{group} gradient")
    start = options_scene[7][group]
    jp = option_steps["jax"][1][2][group]
    tp = option_steps["port"][1][2][group]
    assert np.abs(jp - start).max() > 0
    # The updates, of order 3e-6, land on parameters of order 1: one
    # float32 ulp of the parameters joins the gradient tolerance.
    ulp = np.spacing(np.abs(start).max().astype(np.float32))
    np.testing.assert_allclose(
        tp - start, jp - start, rtol=5e-4,
        atol=5e-5 * np.abs(jp - start).max() + ulp,
        err_msg=f"{group} update")


def test_streaming_bit_identical(options_scene):
    """Budget 0 streams every frame from pinned host memory (plain host
    memory on the CPU); the trajectory is the cached one, bit for bit."""
    runs = []
    for budget in (4 << 30, 0):
        tr = port_options_trainer(options_scene, budget)
        assert tr.streaming == (budget == 0)
        losses = [tr.train_one_step()["loss"] for _ in range(4)]
        runs.append((losses, {k: v.detach().clone()
                              for k, v in {**tr.params,
                                           **tr.camera_params}.items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_streaming_agrees_with_jax(option_steps):
    """The step comparison above runs both packages at budget 0, each
    streaming its frames from the host, as tests/test_training.py::
    test_streaming_matches_device_cached runs JAX's."""
    assert option_steps["streaming"] == (True, True)


# ------------------------------------------------------------------ LPIPS
VGG_WIDTHS = (8, 8, 12, 12, 16, 16, 16, 24, 24, 24, 24, 24, 24)


def synthetic_vgg(directory):
    """VGG16-shaped LPIPS weights at narrow widths, in the converter's
    layout (scripts/convert_weights.py: conv{j}.w [out, in, 3, 3],
    conv{j}.b, lin{i} over each stage's channels)."""
    rng = np.random.default_rng(8)
    out, cin = {}, 3
    for j, cout in enumerate(VGG_WIDTHS):
        out[f"conv{j}.w"] = (rng.normal(size=(cout, cin, 3, 3))
                             * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        out[f"conv{j}.b"] = (0.01 * rng.normal(size=cout)).astype(np.float32)
        cin = cout
    for i, j in enumerate((1, 3, 6, 9, 12)):
        out[f"lin{i}"] = rng.uniform(0, 1, VGG_WIDTHS[j]).astype(np.float32)
    directory.mkdir(parents=True, exist_ok=True)
    np.savez(directory / "vgg16_lpips.npz", **out)
    return out


def test_lpips_matches(tmp_path, monkeypatch):
    weights = synthetic_vgg(tmp_path / "w")
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(tmp_path / "w"))
    assert tlp.lpips_available()
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in weights.items()}
    want = float(jlp._lpips_pair(jparams, jnp.asarray(a) * 2 - 1,
                                 jnp.asarray(b) * 2 - 1))
    got = tlp.lpips(a, b, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want > 0 and tlp.lpips(a, a, device="cpu") < 1e-6


def test_lpips_gating(tmp_path, monkeypatch):
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(tmp_path / "none"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if tlp.lpips_available():
        pytest.skip("a vgg16_lpips.npz in the repository's weights/")
    with pytest.raises(RuntimeError, match="VGG16"):
        tlp.lpips(np.zeros((16, 16, 3)), np.zeros((16, 16, 3)),
                  device="cpu")


@pytest.mark.parametrize("with_weights", [False, True],
                         ids=["no_weights", "weights"])
def test_eval_image_lpips_key(tmp_path, monkeypatch, options_scene,
                              with_weights):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(tmp_path / "w"))
    if with_weights:
        synthetic_vgg(tmp_path / "w")
    jlp._load_params.cache_clear()
    init, alive, cams, tcams, images, cfg, tcfg, _ = options_scene
    jtr = JTrainer(JConfig(model=cfg), cams, images,
                   {k: jnp.asarray(v) for k, v in init.items()},
                   jnp.asarray(alive))
    ttr = Trainer(TrainerConfig(model=tcfg), tcams, images,
                  params_from_numpy(init, device="cpu"),
                  torch.from_numpy(alive), device="cpu")
    # Another camera's image: the render of camera 0 is images[0] itself.
    jev = jtr.eval_image(cams[0], images[1])
    tev = ttr.eval_image(tcams[0], images[1])
    jlp._load_params.cache_clear()
    assert set(tev) == set(jev)
    assert ("lpips" in tev) == with_weights
    np.testing.assert_allclose(tev["psnr"], jev["psnr"], rtol=1e-5)
    if with_weights:
        np.testing.assert_allclose(tev["lpips"], jev["lpips"], rtol=1e-4)


# ------------------------------------------------------ the batched render
def test_render_tiled_batch():
    p, K, c2w = numpy_scene(120, seed=10, width=48, height=48)
    rng = np.random.default_rng(10)
    jcams, tcams = [], []
    for i in range(3):
        c = c2w.copy()
        c[:3, 3] += 0.05 * rng.normal(size=3)
        jc, tc = both_cameras(K, c, 48, 48)
        jcams.append(jc)
        tcams.append(tc)
    means, quats = p["means"], p["quats"] / np.linalg.norm(
        p["quats"], axis=-1, keepdims=True)
    scales = np.exp(p["scales"])
    opac = 1 / (1 + np.exp(-p["opacities"][:, 0]))
    colors = np.clip(p["features_dc"] * 0.28209479 + 0.5, 0, 1)
    args = [np.asarray(x, np.float32) for x in
            (means, quats, scales, opac, colors)]
    jopts = jrast.RenderOptions(tile_capacity=128, max_intersections=1 << 13)
    topts = TOpts(tile_capacity=128, max_intersections=1 << 13)
    from collab_splats_tpu.core.cameras import Camera as JCamera
    jstacked = JCamera(K=jnp.stack([c.K for c in jcams]),
                       c2w=jnp.stack([c.c2w for c in jcams]),
                       width=48, height=48)
    jbatch = jrast.render_tiled_batch(*map(jnp.asarray, args), jstacked,
                                      jopts)
    tbatch = trast.render_tiled_batch(*map(torch.from_numpy, args),
                                      stack_cameras(tcams), topts)
    assert tbatch.color.shape == (3, 48, 48, 3)
    assert tbatch.spilled.shape == (3,)
    np.testing.assert_allclose(tbatch.color.numpy(), np.asarray(jbatch.color),
                               atol=5e-6)
    np.testing.assert_allclose(tbatch.depth.numpy(), np.asarray(jbatch.depth),
                               atol=1e-4)
    for i, cam in enumerate(tcams):
        single, _ = trast.render_tiled(*map(torch.from_numpy, args), cam,
                                       topts)
        for a, b in zip(tbatch, single):
            assert torch.equal(a[i], b)


# ---------------------------------------------------------------- writers
def test_jsonl_records(tmp_path):
    w = twriters.JsonlWriter(tmp_path)
    w.write(1, {"loss": 0.5, "psnr": np.float32(20.0)})
    w.write(2, {"loss": 0.25})
    w.close()
    lines = [json.loads(ln) for ln in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["step"] == 1 and lines[0]["psnr"] == 20.0
    assert lines[1]["loss"] == 0.25


def test_tfevents_round_trip_both_ways(tmp_path):
    for i, (write, read) in enumerate(((twriters, jwriters),
                                       (jwriters, twriters))):
        w = write.TensorboardWriter(tmp_path / str(i))
        w.write(10, {"loss": 1.5, "psnr": 22.5})
        w.write(20, {"loss": 0.75})
        w.close()
        events = read.read_tfevents_scalars(w.path)
        by = {(e["step"], e["tag"]): e["value"] for e in events}
        assert by == {(10, "loss"): 1.5, (10, "psnr"): 22.5,
                      (20, "loss"): 0.75}


def test_crc32c_known_vector():
    assert twriters._crc32c(b"\x00" * 32) == 0x8A9136AA
    assert twriters._crc32c(b"123456789") == 0xE3069283


def test_make_writers(tmp_path):
    out = twriters.make_writers("jsonl,tensorboard", tmp_path)
    assert [type(w).__name__ for w in out] == ["JsonlWriter",
                                               "TensorboardWriter"]
    for w in out:
        w.close()
    with pytest.raises(ValueError):
        twriters.make_writers("mystery", tmp_path)


def test_trainer_writes_every_step(tmp_path, options_scene):
    ws = twriters.make_writers("jsonl,tensorboard", tmp_path)
    tr = port_options_trainer(options_scene, writers=ws)
    tr.train(num_steps=3, log_every=100)
    for w in ws:
        w.close()
    lines = [json.loads(ln) for ln in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert lines[2]["loss"] == tr.history[2]["loss"]
    assert "tv_loss" in lines[0]
    events = twriters.read_tfevents_scalars(ws[1].path)
    assert {e["step"] for e in events if e["tag"] == "loss"} == {1, 2, 3}


# ------------------------------------------------------------ checkpoints
def test_checkpoint_both_groups_both_ways(tmp_path, options_scene):
    jtr = jax_options_trainer(options_scene)
    jtr.train_one_step()
    jtr.save(tmp_path / "jax")
    ttr = port_options_trainer(options_scene)
    ttr.restore(tckpt.latest_checkpoint(tmp_path / "jax"))
    assert ttr.step == 1
    jflat = {f"opt/{k}": v for k, v in _flatten(jtr.opt_state).items()}
    tflat = tckpt.optimizer_to_flat(ttr.optimizer)
    for group in ("camera_opt", "bilateral_grid"):
        np.testing.assert_array_equal(
            ttr.camera_params[group].detach().numpy(),
            np.asarray(jtr.params[group]))
        for a, b in zip(moments(tflat, group), moments(jflat, group)):
            np.testing.assert_array_equal(a, b)
    # The port's save, resumed by JAX.
    ttr.train_one_step()
    ttr.save(tmp_path / "port")
    jtr2 = jax_options_trainer(options_scene)
    jtr2.restore(tckpt.latest_checkpoint(tmp_path / "port"))
    assert jtr2.step == 2
    jflat = {f"opt/{k}": v for k, v in _flatten(jtr2.opt_state).items()}
    tflat = tckpt.optimizer_to_flat(ttr.optimizer)
    for group in ("camera_opt", "bilateral_grid"):
        np.testing.assert_array_equal(
            np.asarray(jtr2.params[group]),
            ttr.camera_params[group].detach().numpy())
        for a, b in zip(moments(jflat, group), moments(tflat, group)):
            np.testing.assert_array_equal(a, b)

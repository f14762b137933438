"""The at-scale entry points against the JAX package's scripts, on the CPU.

``collab_splats_tpu_torch/scripts/{scale_train,mesh_eval,
feature_chain_eval}.py`` against ``scripts/`` of the JAX package:

* the seeded initialization (positions, DC by ``rgb_to_sh0`` or the
  logit, padding) equals JAX's lines on one numpy cloud within 1e-6, and
  the ``TrainerConfig``, strategy and model fields equal JAX's;
* a tiny ``--cpu`` run (64x36, 2,000 seeds, capacity 2,048, 40 steps,
  ``--res-schedule 10 --reg-from 20``) writes 40 finite rows, checkpoints
  that JAX's ``load_checkpoint`` reads as equal arrays, and a summary with
  ``runs/scale_r5/summary.json``'s keys.  Two departures from the flags
  the reference would suggest: one downscale, since 64x36 at the default
  two renders 16x9, under SSIM's 11-pixel window, where JAX's loss is NaN;
  2,000 seeds, since 200 Gaussians of scale 0.02 leave every 64x36 view
  under the TSDF's alpha threshold, so the mesh would be empty.  The
  schedule is shortened (warmup 10, a refine every 5 steps, a reset at
  step 5, splits off from step 15, so the refines cull only), which makes
  the capacity grow at the first refine with the Adam moments carried;
* a resume from the run's step-20 checkpoint in a copy of its directory
  (a kill after step 40) moves the history to ``history_prekill.jsonl``
  and replays steps 21-40 to the same bits: every row but ``wall_s``, and
  every array of the step-40 checkpoint;
* the step-40 checkpoint through JAX's ``scripts/mesh_eval.py::main`` and
  the port's ``evaluate_mesh``: vertex count within 2% and completeness
  within 1 percentage point, as tests/test_torch_meshing.py allows for
  voxel decisions that XLA's fused rounding of the voxel projection can
  flip, and accuracy within 2% relative; a transparent table gives JAX's
  empty-mesh payload and exit code;
* a tiny ``--features`` checkpoint through JAX's
  ``scripts/feature_chain_eval.py::main`` and the port's ``run_chain``,
  with one text embedding carried across (the offline text towers draw
  from different generators): the port's query of JAX's per-vertex
  latents gives JAX's similarity statistics within 1e-5, its own mesh's
  within 1e-3;
* every ``main`` without ``--cpu`` raises on a machine without a card.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collab_splats_tpu.features.extractors as jextractors
import collab_splats_tpu.utils.cache as jcache
from collab_splats_tpu.core.options import RenderOptions as JRenderOptions
from collab_splats_tpu.core.sh import num_sh_bases as jnum_sh_bases
from collab_splats_tpu.core.sh import rgb_to_sh0 as jrgb_to_sh0
from collab_splats_tpu.models import rade_features as jrade_features
from collab_splats_tpu.models import rade_gs as jrade_gs
from collab_splats_tpu.models.gaussians import pad_to_capacity as jpad
from collab_splats_tpu.train import checkpoint as jckpt
from collab_splats_tpu.train import strategy as jstrategy
from collab_splats_tpu.train.trainer import TrainerConfig as JTrainerConfig
from collab_splats_tpu_torch.features import extractors as textractors
from collab_splats_tpu_torch.features.decoder import (decoder_from_numpy,
                                                     decoder_to_numpy)
from collab_splats_tpu_torch.models import rade_features
from collab_splats_tpu_torch.scripts import (feature_chain_eval, mesh_eval,
                                             scale_train)
from collab_splats_tpu_torch.train import checkpoint as ckpt
from collab_splats_tpu_torch.train.strategy import StrategyConfig

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
REFERENCE_SUMMARY = ROOT / "runs" / "scale_r5" / "summary.json"
TINY = ["--cpu", "--analytic-gt", "--sh-degree", "3", "--exact-binning",
        "--width", "64", "--height", "36", "--num-downscales", "1",
        "--seed-points", "2000", "--capacity", "2048", "--steps", "40",
        "--res-schedule", "10", "--reg-from", "20", "--save-every", "10",
        "--eval-every", "20", "--eval-cams", "2"]
SHORT_SCHEDULE = StrategyConfig(warmup_length=10, refine_every=5,
                                reset_alpha_every=2, stop_split_at=15)
# The evaluations' tiny flags, in both packages' spellings.
MESH_FLAGS = ["--width", "64", "--height", "36", "--n-cams", "8",
              "--voxel", "0.05", "--max-dim", "64"]
MESH_KW = dict(width=64, height=36, n_cams=8, voxel=0.05, max_dim=64)


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(name, argv, monkeypatch):
    """A JAX script's ``main`` on ``argv``: (stdout's last line as JSON,
    the exit code)."""
    mod = load_jax_script(name)
    # XLA's persistent compile cache would be written under $HOME.
    monkeypatch.setattr(jcache, "enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    out, code = io.StringIO(), 0
    with contextlib.redirect_stdout(out):
        try:
            mod.main()
        except SystemExit as e:
            code = e.code
    return json.loads(out.getvalue().strip().splitlines()[-1]), code


def rows(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


def without_wall(row):
    return {k: v for k, v in row.items() if k != "wall_s"}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("scale") / "run"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scale_train, "SCHEDULE", SHORT_SCHEDULE)
        assert scale_train.main(TINY + ["--out", str(out)]) == 0
    return out


# ----------------------------------------------------------------- setup
@pytest.mark.parametrize("sh_degree,colours", [(0, True), (3, True),
                                               (3, False)])
def test_init_matches_jax(sh_degree, colours):
    rng = np.random.default_rng(0)
    n, capacity = 300, 512
    means = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = np.clip(rng.uniform(0, 1, (n, 3)), 0.02, 0.98).astype(
        np.float32) if colours else None
    got, alive, decoder = scale_train.init_params(means, rgb, sh_degree,
                                                  capacity, "cpu")
    assert decoder is None
    # JAX's scripts/scale_train.py lines of the seeded initialization.
    if rgb is None:
        dc = jnp.zeros((n, 3))
    elif sh_degree > 0:
        dc = jrgb_to_sh0(jnp.asarray(rgb))
    else:
        dc = jnp.log(rgb / (1.0 - rgb))
    ref = jpad({
        "means": jnp.asarray(means),
        "quats": jnp.tile(jnp.array([[1.0, 0, 0, 0]]), (n, 1)),
        "scales": jnp.log(jnp.full((n, 3), 0.02)),
        "opacities": jnp.full((n, 1), 0.0),
        "features_dc": jnp.asarray(dc),
        "features_rest": jnp.zeros((n, jnum_sh_bases(sh_degree) - 1, 3)),
    }, capacity)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(alive.numpy(), np.arange(capacity) < n)


def test_feature_init_adds_latents_and_decoder():
    dims = (("clip-vit", (768, 36, 64)), ("dinov2", (384, 32, 57)))
    args = scale_train.parse_args(["--features", "--sh-degree", "3"])
    cfg = scale_train.model_config(args, dims)
    got, _, decoder = scale_train.init_params(
        np.zeros((10, 3), np.float32), None, 3, 16, "cpu", cfg, seed=42)
    assert got["distill_features"].shape == (16, 13)
    assert not got["distill_features"].any()
    # JAX's decoder subtree, in its [in, out] layout.
    assert {k: v.shape for k, v in decoder_to_numpy(decoder).items()} == {
        "hidden_w": (13, 64), "hidden_b": (64,),
        "branch_clip-vit_w": (64, 768), "branch_clip-vit_b": (768,),
        "branch_dinov2_w": (64, 384), "branch_dinov2_b": (384,)}


def test_make_scene_matches_jax_layout():
    """The self-rendered ground truth: JAX's layout (12 clusters of 1,500
    and a 4,000-splat slab, the same shapes and value ranges, 64 orbit
    cameras); the draws are a torch generator's, not jax.random's."""
    ref, jcams = load_jax_script("scale_train").make_scene(
        jax.random.PRNGKey(1), width=64, height=36)
    got, cams = scale_train.make_scene(torch.Generator().manual_seed(1),
                                       width=64, height=36, device="cpu")
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for k in ("scales", "opacities"):
        for part in (slice(0, 18000), slice(18000, None)):
            np.testing.assert_allclose(
                [got[k][part].min(), got[k][part].max()],
                [np.asarray(ref[k][part]).min(),
                 np.asarray(ref[k][part]).max()], atol=0.05, err_msg=k)
    assert len(cams) == len(jcams) == 64
    for c, j in zip(cams[::16], jcams[::16]):
        np.testing.assert_allclose(c.c2w.numpy(), np.asarray(j.c2w),
                                   atol=1e-6)
        np.testing.assert_allclose(c.K.numpy(), np.asarray(j.K), atol=1e-5)


def field_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("features", [False, True])
def test_configs_match_jax(features):
    argv = ["--analytic-gt", "--sh-degree", "3", "--exact-binning",
            "--steps", "3200", "--res-schedule", "1000", "--reg-from",
            "2200"] + (["--features"] if features else [])
    args = scale_train.parse_args(argv)
    dims = (("clip-vit", (768, 36, 64)), ("dinov2", (384, 36, 64))) \
        if features else None
    tc = scale_train.trainer_config(args, scale_train.model_config(args,
                                                                   dims))
    # JAX's scripts/scale_train.py lines of the configuration.
    render = JRenderOptions(rasterize_mode="antialiased",
                            exact_binning=True, pallas_batched=False)
    common = dict(sh_degree=3, background="random", render=render,
                  use_depth_normal_loss=True, regularization_from_iter=2200)
    jmodel = jrade_features.RadeFeaturesConfig(feature_dims=dims, **common) \
        if features else jrade_gs.RadeGSConfig(**common)
    jtc = JTrainerConfig(model=jmodel, strategy=jstrategy.StrategyConfig(),
                         max_iterations=3200, num_downscales=2,
                         resolution_schedule=1000, seed=42, scene_scale=1.2)
    got, ref = field_dict(tc), field_dict(jtc)
    assert set(got) == set(ref)
    for name in ref:
        if name == "strategy":
            assert field_dict(got[name]) == field_dict(ref[name])
        elif name == "model":
            assert type(got[name]).__name__ == type(ref[name]).__name__
            gm, jm = field_dict(got[name]), field_dict(ref[name])
            assert set(gm) == set(jm)
            for k in jm:
                if k == "render":
                    gr = field_dict(gm[k])
                    # The port leaves out the options that pick TPU
                    # kernels or steer XLA's memory (core/options.py).
                    assert gr == {f: v for f, v in field_dict(jm[k]).items()
                                  if f in gr}
                else:
                    assert gm[k] == jm[k], k
        else:
            assert got[name] == ref[name], name


# ------------------------------------------------------------------- run
def test_tiny_run(tiny_run):
    hist = rows(tiny_run / "history.jsonl")
    assert [r["step"] for r in hist] == list(range(1, 41))
    for r in hist:
        assert all(np.isfinite(v) for v in r.values()), r
    assert "depth_normal_loss" not in hist[19]
    assert "depth_normal_loss" in hist[20]
    assert [r["step"] for r in hist if "eval_psnr" in r] == [20, 40]
    assert [r["step"] for r in hist if "refine_cull" in r] == [15, 20, 25,
                                                                30, 35]
    summary = json.loads((tiny_run / "summary.json").read_text())
    assert set(summary) == set(json.loads(REFERENCE_SUMMARY.read_text()))
    assert summary["capacity"] == 4096       # grown at the first refine
    assert summary["nonfinite_grad_steps"] == 0
    for step in (10, 20, 30, 40):
        path = tiny_run / f"step-{step:08d}.ckpt.npz"
        jstep, jparams, jalive, _ = jckpt.load_checkpoint(path)
        tstep, tparams, talive, _ = ckpt.load_checkpoint(path, "cpu")
        assert jstep == tstep == step
        np.testing.assert_array_equal(np.asarray(jalive), talive.numpy())
        assert set(jparams) == set(tparams)
        for k in tparams:
            np.testing.assert_array_equal(np.asarray(jparams[k]),
                                          tparams[k].numpy())


def test_kill_and_resume(tiny_run, tmp_path, monkeypatch):
    out = tmp_path / "run"
    shutil.copytree(tiny_run, out)
    monkeypatch.setattr(scale_train, "SCHEDULE", SHORT_SCHEDULE)
    ref = dict(np.load(tiny_run / "step-00000040.ckpt.npz"))
    args = scale_train.parse_args(TINY + [
        "--out", str(out), "--resume", str(out / "step-00000020.ckpt.npz")])
    res = scale_train.run(args, log=lambda s: None)
    assert res.trainer.step == 40 and res.summary is not None
    before = rows(tiny_run / "history.jsonl")
    assert rows(out / "history_prekill.jsonl") == before
    after = rows(out / "history.jsonl")
    assert [without_wall(r) for r in after] == [without_wall(r)
                                                for r in before]
    assert after[:20] == before[:20]         # kept as they were written
    got = dict(np.load(out / "step-00000040.ckpt.npz"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ------------------------------------------------------------ evaluations
@pytest.mark.parametrize("table", ["trained", "transparent"])
def test_mesh_eval_matches_jax(tiny_run, tmp_path, monkeypatch, table):
    path = tiny_run / "step-00000040.ckpt.npz"
    if table == "transparent":
        arrays = dict(np.load(path))
        arrays["params/opacities"] = np.full_like(
            arrays["params/opacities"], -10.0)
        path = tmp_path / "step-00000040.ckpt.npz"
        np.savez(path, **arrays)
    argv = [str(path), "--cpu", "--gt-samples", "20000"] + MESH_FLAGS
    if table == "transparent":
        # JAX's empty-mesh payload and exit code 1.
        with contextlib.redirect_stdout(io.StringIO()) as out:
            assert mesh_eval.main(argv) == 1
        assert json.loads(out.getvalue()) == {
            "ckpt": str(path), "step": 40, "n_vertices": 0,
            "accuracy_p90": None, "completeness_pct": 0.0,
            "note": "empty mesh (no surface crossed the TSDF iso level)"}
        return
    got = mesh_eval.evaluate_mesh(path, gt_samples=20000, device="cpu",
                                  **MESH_KW)
    ref, jcode = run_jax_main("mesh_eval", argv, monkeypatch)
    assert jcode in (0, None)
    assert set(got) == set(ref)
    assert got["step"] == ref["step"] == 40
    assert got["n_vertices"] > 500
    assert abs(got["n_vertices"] - ref["n_vertices"]) <= 0.02 * \
        ref["n_vertices"]
    np.testing.assert_allclose(got["accuracy_p90"], ref["accuracy_p90"],
                               rtol=0.02)
    assert abs(got["completeness_pct"] - ref["completeness_pct"]) <= 1.0


def test_feature_chain_matches_jax(tmp_path, monkeypatch):
    run_dir = tmp_path / "features"
    real = textractors.get_extractor
    monkeypatch.setattr(scale_train, "SCHEDULE", SHORT_SCHEDULE)
    # The offline towers at a 112-pixel input: the chain, not the towers,
    # is under test (tests/test_torch_extractors.py holds those).
    monkeypatch.setattr(
        scale_train, "get_extractor",
        lambda name, device=None: real(name, device=device, resolution=112))
    flags = list(TINY)
    flags[flags.index("--steps") + 1] = "5"
    flags[flags.index("--save-every") + 1] = "5"
    flags[flags.index("--capacity") + 1] = "4096"
    assert scale_train.main(flags + ["--features", "--out",
                                     str(run_dir)]) == 0
    prompts = ["sphere", "floor", "wall"]
    emb = torch.nn.functional.normalize(torch.randn(
        (len(prompts), 768), generator=torch.Generator().manual_seed(0)),
        dim=1)
    got = feature_chain_eval.run_chain(
        run_dir, out=tmp_path / "port_mesh", device="cpu",
        text_embeddings=emb, **MESH_KW)

    class CarriedText:
        def encode_text(self, texts):
            assert list(texts) == prompts
            return emb.numpy()

    monkeypatch.setattr(jextractors, "get_extractor",
                        lambda name, **kw: CarriedText())
    ref, _ = run_jax_main("feature_chain_eval", [
        str(run_dir), "--cpu", "--out", str(tmp_path / "jax_mesh")]
        + MESH_FLAGS, monkeypatch)
    assert set(got) == set(ref)
    for k in ("ckpt", "step", "latent_dim", "positive", "negative"):
        assert got[k] == ref[k], k
    assert abs(got["n_vertices"] - ref["n_vertices"]) <= 0.02 * \
        ref["n_vertices"]
    # The port's query over JAX's mesh: its per-vertex latents carried.
    jlatents = np.load(tmp_path / "jax_mesh" / "mesh_features.npz")[
        "features"]
    assert jlatents.shape == (ref["n_vertices"], 13)
    _, _, _, extras = ckpt.load_checkpoint(
        ckpt.latest_checkpoint(run_dir), "cpu")
    arrays = ckpt.decoder_arrays(extras)
    cfg = rade_features.RadeFeaturesConfig(
        feature_dims=feature_chain_eval.feature_dims_from_decoder(arrays))
    with torch.no_grad():
        sims = rade_features.query_vertices(
            decoder_from_numpy(arrays, "cpu"), torch.from_numpy(jlatents),
            emb, 1, cfg).numpy()
    for stat, fn, tol in (("min", np.min, 1e-5), ("max", np.max, 1e-5),
                          ("mean", np.mean, 1e-5)):
        np.testing.assert_allclose(float(fn(sims)), ref[f"similarity_{stat}"],
                                   rtol=0, atol=tol, err_msg=stat)
        np.testing.assert_allclose(got[f"similarity_{stat}"],
                                   ref[f"similarity_{stat}"], rtol=0,
                                   atol=1e-3, err_msg=stat)
    for name in ("mesh.ply", "mesh_queried.ply", "mesh_features.npz"):
        assert (tmp_path / "port_mesh" / name).exists(), name


@pytest.mark.parametrize("module,argv", [
    (scale_train, ["--steps", "1", "--out", "unused"]),
    (mesh_eval, ["missing/step-00000001.ckpt.npz"]),
    (feature_chain_eval, ["missing/step-00000001.ckpt.npz"]),
])
def test_main_needs_a_card_without_cpu(module, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)

"""The port's checkpoints: the JAX package's file and keys, both ways.

Mirrors tests/test_data.py's checkpoint cases (the round trip with
metadata, the nested decoder) for ``train/checkpoint.py``, then holds the
format against the JAX package's on a rade-features trainer (N = 400,
48x48, two cameras, black background): a JAX ``Trainer.save`` resumes in
the port's ``Trainer.restore`` and the next step's loss agrees within rtol
1e-5 (a step from equal parameters, as tests/test_torch_train_step.py
holds one), the step after within rtol 1e-3 (whole steps, as
tests/test_torch_trainer.py); a port ``save`` loads in JAX's
``load_checkpoint`` as equal arrays and resumes in JAX's ``restore`` the
same way.  Last, a kill and a resume from the last save on the CPU give
the bits of the run that was not killed, across a refine pass.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.train import checkpoint as jckpt
from collab_splats_tpu.train import optim as joptim
from collab_splats_tpu.train.trainer import Trainer as JTrainer
from collab_splats_tpu_torch.features import decoder as tdec
from collab_splats_tpu_torch.models.gaussians import (pad_to_capacity,
                                                      params_from_numpy)
from collab_splats_tpu_torch.train import checkpoint as ckpt
from collab_splats_tpu_torch.train import optim, strategy
from collab_splats_tpu_torch.train.trainer import Trainer
from test_torch_core import both_cameras, numpy_scene
from test_torch_features import N, trainer_configs, trainer_scene

torch.set_num_threads(2)


def test_roundtrip(tmp_path):
    p = params_from_numpy(numpy_scene(32, seed=3)[0], device="cpu")
    params = {k: v.requires_grad_(True) for k, v in p.items()}
    alive = torch.arange(32) < 30
    opt, _ = optim.make_optimizer(params, optim.RADE_GS_GROUPS)
    strat = strategy.init_state(32, "cpu")
    path = ckpt.save_checkpoint(tmp_path / "ckpt", 1234, params, alive,
                                optimizer=opt, strat_state=strat,
                                metadata={"method": "rade-gs"})
    assert path.name == "step-00001234.ckpt.npz"
    assert ckpt.latest_checkpoint(tmp_path / "ckpt") == path
    step, params2, alive2, extras = ckpt.load_checkpoint(path, device="cpu")
    assert step == 1234
    assert set(params2) == set(params)
    for k in params:
        assert torch.equal(params2[k], params[k].detach()), k
    assert torch.equal(alive2, alive)
    assert any(k.startswith("opt/") for k in extras)
    assert {k for k in extras if k.startswith("strat/")} == {
        "strat/.grad_accum", "strat/.count", "strat/.max_radii"}
    meta = json.loads((tmp_path / "ckpt" / "metadata.json").read_text())
    assert meta == {"step": 1234, "method": "rade-gs"}


def test_decoder_subtree_roundtrip(tmp_path):
    """The decoder goes to ``params/decoder/<k>`` in JAX's [in, out]
    layout, loads back into the port, and loads in JAX as its nested
    subtree; no pickled objects."""
    p = params_from_numpy(numpy_scene(16, seed=4)[0], device="cpu")
    dec = tdec.TwoLayerDecoder(13, 8, {"clip-vit": (4, 2, 2)},
                               generator=torch.Generator().manual_seed(1),
                               device="cpu")
    path = ckpt.save_checkpoint(tmp_path, 7, p, torch.ones(16, dtype=bool),
                                decoder=dec)
    with np.load(path) as data:
        assert data["params/decoder/hidden_w"].shape == (13, 8)
    _, params2, _, extras = ckpt.load_checkpoint(path, device="cpu")
    assert "decoder" not in params2
    back = tdec.decoder_from_numpy(ckpt.decoder_arrays(extras), device="cpu")
    for a, b in zip(back.parameters(), dec.parameters()):
        assert torch.equal(a, b)
    _, jparams, _, _ = jckpt.load_checkpoint(path)
    assert isinstance(jparams["decoder"], dict)
    np.testing.assert_array_equal(jparams["decoder"]["hidden_w"],
                                  dec.hidden.weight.detach().numpy().T)


def test_latest_checkpoint(tmp_path):
    assert ckpt.latest_checkpoint(tmp_path / "missing") is None
    assert ckpt.latest_checkpoint(tmp_path) is None
    p = params_from_numpy(numpy_scene(4)[0], device="cpu")
    alive = torch.ones(4, dtype=bool)
    for step in (30, 2000, 400):
        ckpt.save_checkpoint(tmp_path, step, p, alive)
    assert ckpt.latest_checkpoint(tmp_path).name == "step-00002000.ckpt.npz"


def port_trainer(conf, p, cams, images, feats, dec, alive=None, **kw):
    return Trainer(conf, [both_cameras(K, c, 48, 48)[1] for K, c in cams],
                   images, params_from_numpy(p, device="cpu"),
                   torch.ones(N, dtype=torch.bool) if alive is None
                   else alive, features=feats,
                   decoder=tdec.decoder_from_numpy(dec, device="cpu"),
                   device="cpu", **kw)


def jax_flat(jtr):
    return {**{f"opt/{k}": v
               for k, v in jckpt._flatten(jtr.opt_state).items()},
            **{f"strat/{k}": v
               for k, v in jckpt._flatten(jtr.strat_state).items()}}


def port_flat(tr):
    return {**ckpt.optimizer_to_flat(tr.optimizer, tr.decoder),
            **{f"strat/.{k}": x.numpy() for k, x in
               zip(strategy.StrategyState._fields, tr.strat_state)}}


def assert_step_close(a, b, rtol):
    for k in ("loss", "rgb_loss", "features_loss", "depth_normal_loss",
              "psnr"):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)


def test_checkpoints_resume_across_packages(tmp_path):
    p, cams, images, feats, dec = trainer_scene()
    jconf, tconf = trainer_configs()
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    jparams["decoder"] = {k: jnp.asarray(v) for k, v in dec.items()}
    jtr = JTrainer(jconf, [both_cameras(K, c, 48, 48)[0] for K, c in cams],
                   images, jparams, jnp.ones(N, bool),
                   groups=joptim.RADE_FEATURES_GROUPS, features=feats)
    tr = port_trainer(tconf, p, cams, images, feats, dec)

    # JAX -> port.
    for _ in range(2):
        jtr.train_one_step()
    jtr.save(tmp_path / "jax")
    tr.restore(ckpt.latest_checkpoint(tmp_path / "jax"))
    assert tr.step == 2
    flat, ref = port_flat(tr), jax_flat(jtr)
    assert set(flat) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    for k, v in jtr.params.items():
        if k != "decoder":
            np.testing.assert_array_equal(tr.params[k].detach().numpy(),
                                          np.asarray(v), err_msg=k)
    lrs = {g["name"]: g["lr"] for g in tr.optimizer.param_groups}
    sched = joptim.nerfstudio_exponential_decay(
        joptim.RADE_FEATURES_GROUPS["distill_features"])
    np.testing.assert_allclose(lrs["distill_features"], float(sched(2)),
                               rtol=1e-6)
    assert_step_close(tr.train_one_step(), jtr.train_one_step(), 1e-5)
    assert_step_close(tr.train_one_step(), jtr.train_one_step(), 1e-3)

    # port -> JAX: the file loads as equal arrays and resumes.
    path = tr.save(tmp_path / "port")
    step, jp, jalive, extras = jckpt.load_checkpoint(path)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(jalive), tr.alive.numpy())
    assert set(jp) == set(tr.params) | {"decoder"}
    for k, v in tr.params.items():
        np.testing.assert_array_equal(np.asarray(jp[k]), v.detach().numpy())
    for k, v in tdec.decoder_to_numpy(tr.decoder).items():
        np.testing.assert_array_equal(np.asarray(jp["decoder"][k]), v)
    flat = port_flat(tr)
    assert set(extras) == set(flat) == set(jax_flat(jtr))
    for k, v in flat.items():
        np.testing.assert_array_equal(extras[k], v, err_msg=k)
    jtr.restore(path)
    for k, v in jax_flat(jtr).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
    assert_step_close(tr.train_one_step(), jtr.train_one_step(), 1e-5)


def test_kill_and_resume_is_bit_identical(tmp_path):
    """Run A trains 8 steps, saving every 4 through ``checkpoint_fn``; run
    B is a fresh trainer that restores A's step-4 checkpoint and trains to
    step 8.  B's steps cross a capacity growth and two refine passes that
    duplicate and split; every parameter, the decoder,
    the alive mask, the Adam state, the statistics and the history must
    come out the same bits."""
    p, cams, images, feats, dec = trainer_scene()
    p = {k: v.numpy() for k, v in pad_to_capacity(
        params_from_numpy(p, device="cpu"), 480).items()}
    alive = torch.arange(480) < N
    _, tconf = trainer_configs()
    tconf = tconf.__class__(**{
        **tconf.__dict__, "steps_per_save": 4,
        "strategy": strategy.StrategyConfig(
            warmup_length=3, refine_every=2, densify_grad_thresh=1e-6)})

    def trainer():
        return port_trainer(tconf, p, cams, images, feats, dec, alive=alive,
                            checkpoint_fn=lambda t: t.save(tmp_path))

    a = trainer()
    a.train(8, log_fn=lambda _: None)
    assert sorted(x.name for x in tmp_path.glob("*.npz")) == [
        "step-00000004.ckpt.npz", "step-00000008.ckpt.npz"]
    refined = [h for h in a.history if "refine_dup" in h]
    assert len(refined) == 2
    assert all(h["refine_dup"] + h["refine_split"] > 0 for h in refined)
    assert a.alive.shape[0] > 480        # the capacity grew

    b = trainer()
    b.restore(tmp_path / "step-00000004.ckpt.npz")
    b.train(4, log_fn=lambda _: None)
    assert b.step == a.step == 8
    assert b.history == a.history[4:]
    assert torch.equal(b.alive, a.alive)
    for k in a.params:
        assert torch.equal(b.params[k], a.params[k]), k
    for x, y in zip(b.decoder.parameters(), a.decoder.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(b.strat_state, a.strat_state):
        assert torch.equal(x, y)
    assert [g["lr"] for g in b.optimizer.param_groups] == \
        [g["lr"] for g in a.optimizer.param_groups]
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for key, v in st.items():
            assert torch.equal(sb["state"][i][key], v), (i, key)


def test_load_state_numpy_keeps_groups_the_file_lacks(tmp_path):
    """A group missing from the file keeps its state; groups whose update
    counts disagree are refused."""
    p, cams, images, feats, dec = trainer_scene()
    _, tconf = trainer_configs()
    tr = port_trainer(tconf, p, cams, images, feats, dec)
    tr.train_one_step()
    with np.load(tr.save(tmp_path)) as data:
        flat = {k: data[k] for k in data.files
                if "['distill_features']" not in k}
    before = tr.optimizer.state[tr.params["distill_features"]]["exp_avg"]
    before = before.clone()
    tr.train_one_step()
    tr.load_state_numpy(flat)
    st = tr.optimizer.state
    assert float(st[tr.params["means"]]["step"]) == 1.0
    assert float(st[tr.params["distill_features"]]["step"]) == 2.0
    assert not torch.equal(st[tr.params["distill_features"]]["exp_avg"],
                           before)
    flat["opt/.inner_states/['means']/.inner_state/[0]/.count"] = \
        np.asarray(5, np.int32)
    with pytest.raises(ValueError, match="disagree"):
        tr.load_state_numpy(flat)

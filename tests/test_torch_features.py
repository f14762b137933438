"""The port's rade-features path against the JAX package's, on the CPU.

Same seeded numpy inputs through both: the antialiased bilinear resize
(``jax.image.resize``: down, up and odd sizes, within 1e-6), the decoder
with JAX's weights carried across by ``decoder_from_numpy`` (one
transpose), ``decode_rendered_features``, both similarity methods, the
cosine distillation loss, and ``rade_features.get_loss`` with its
gradients with respect to every Gaussian field, ``distill_features`` and
every decoder tensor, with the batched compositor (``backend="xla"``) and
the per-tile one (``"pallas"``, JAX's Pallas kernels in interpret mode).
Tolerances: the loss within rtol 1e-5, gradients within rtol 5e-4 and
atol 5e-5 * max|g| (tests/test_pallas.py:205-206).  Then three trainer
steps with features against the JAX ``Trainer``, compared on ``history``
(rtol 1e-3, as tests/test_torch_trainer.py compares whole steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.options import RenderOptions as JOpts
from collab_splats_tpu.features import decoder as jdec
from collab_splats_tpu.features.similarity import compute_similarity as jsim
from collab_splats_tpu.models import gaussians as jgauss
from collab_splats_tpu.models import rade_features as jrf
from collab_splats_tpu.ops import rasterize as jrast
from collab_splats_tpu.train import losses as jlosses
from collab_splats_tpu.train import optim as joptim
from collab_splats_tpu.train import strategy as jstrategy
from collab_splats_tpu.train.trainer import Trainer as JTrainer
from collab_splats_tpu.train.trainer import TrainerConfig as JConfig
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.features import decoder as tdec
from collab_splats_tpu_torch.features.similarity import \
    compute_similarity as tsim
from collab_splats_tpu_torch.models import gaussians as tgauss
from collab_splats_tpu_torch.models import rade_features as trf
from collab_splats_tpu_torch.models.gaussians import params_from_numpy
from collab_splats_tpu_torch.ops import rasterize as trast
from collab_splats_tpu_torch.train import losses as tlosses
from collab_splats_tpu_torch.train import optim as toptim
from collab_splats_tpu_torch.train import strategy as tstrategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_core import both_cameras, numpy_scene
from test_torch_strategy import CAP, assert_refine_match, refine_both, table

torch.set_num_threads(2)
N, SIZE, STEP, LATENT = 400, 64, 20, 13
DIMS = (("clip-vit", (16, 8, 8)), ("dinov2", (12, 6, 10)))
OPTS = dict(rasterize_mode="antialiased", tile_capacity=128,
            max_intersections=1 << 14)
NO_REFINE = 10_000_000


def assert_grad_close(a, b, name):
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5 * scale,
                               err_msg=name)


def jax_decoder(seed=1, dims=DIMS, hidden=32):
    return {k: np.asarray(v) for k, v in jdec.init_decoder(
        jax.random.PRNGKey(seed), LATENT, hidden, dict(dims)).items()}


@pytest.mark.parametrize("shape,size", [
    ((720, 1280, 3), (36, 64)),      # the training path's downsample
    ((36, 64, 5), (288, 512)),       # similarity_map's upsample
    ((37, 65, 3), (11, 29)),         # odd sizes, down
    ((9, 7, 2), (20, 3)),            # odd sizes, one axis up, one down
    ((13, 17, 2), (13, 40)),         # one axis kept
], ids=["down", "up", "odd-down", "odd-mixed", "one-axis"])
def test_resize_bilinear_matches_jax_image_resize(shape, size):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), size + shape[2:], method="linear")
    got = tdec.resize_bilinear(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_decoder_from_numpy_transposes_once():
    arrays = jax_decoder()
    dec = tdec.decoder_from_numpy(arrays, device="cpu")
    assert list(dec.branches) == jdec.branch_names(arrays)
    assert tuple(dec.hidden.weight.shape) == arrays["hidden_w"].shape[::-1]
    back = tdec.decoder_to_numpy(dec)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_decoder_init_distribution():
    """He-normal weights and uniform(-1, 1)/sqrt(fan_in) biases, as JAX
    draws them: nonzero biases, bounded by 1/sqrt(fan_in)."""
    dec = tdec.TwoLayerDecoder(LATENT, 64, {"b": (512, 1, 1), "a": (8, 1, 1)},
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    assert list(dec.branches) == ["a", "b"]
    w = dec.branches["b"].weight.detach()
    assert abs(float(w.std()) - np.sqrt(2.0 / 64)) < 0.01
    for layer in (dec.hidden, dec.branches["a"], dec.branches["b"]):
        b = layer.bias.detach()
        bound = 1.0 / np.sqrt(layer.in_features)
        assert float(b.abs().max()) <= bound and float(b.abs().min()) > 0


@pytest.mark.parametrize("per_pixel", [True, False],
                         ids=["map", "per-gaussian"])
def test_decode_matches(per_pixel):
    arrays = jax_decoder()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(12, 9, LATENT) if per_pixel else (50, LATENT))
    x = x.astype(np.float32)
    ref = jdec.decode(arrays, jnp.asarray(x))
    got = tdec.decode(tdec.decoder_from_numpy(arrays, device="cpu"),
                      torch.from_numpy(x))
    for k in ref:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("factor", [1.0, 2.0])
def test_decode_rendered_features_matches(factor):
    arrays = jax_decoder()
    lat = np.random.default_rng(3).normal(
        size=(SIZE, SIZE + 6, LATENT)).astype(np.float32)
    ref = jdec.decode_rendered_features(arrays, jnp.asarray(lat), dict(DIMS),
                                        "clip-vit", resize_factor=factor)
    got = tdec.decode_rendered_features(
        tdec.decoder_from_numpy(arrays, device="cpu"), torch.from_numpy(lat),
        dict(DIMS), "clip-vit", resize_factor=factor)
    assert list(got) == list(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["standard", "pairwise"])
def test_compute_similarity_matches(method):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(16, 7, 5)).astype(np.float32)
    emb = rng.normal(size=(5, 16))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(
        np.float32)
    ref = jsim(jnp.asarray(feats), jnp.asarray(emb), 2, method=method)
    got = tsim(torch.from_numpy(feats), torch.from_numpy(emb), 2,
               method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        tsim(torch.from_numpy(feats), torch.from_numpy(emb), 2, method="x")


def test_cosine_distillation_loss_matches():
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(16, 6, 10)).astype(np.float32)
    gt = rng.normal(size=(16, 6, 10)).astype(np.float32)
    gt[:, 0, 0] = 0.0   # the 1e-16 terms keep a zero vector finite
    ref = jlosses.cosine_distillation_loss(jnp.asarray(pred), jnp.asarray(gt))
    got = tlosses.cosine_distillation_loss(torch.from_numpy(pred),
                                           torch.from_numpy(gt))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def configs(backend):
    kw = dict(background="black", use_depth_normal_loss=True,
              feature_dims=DIMS, mlp_hidden_dim=32)
    pallas = backend == "pallas"
    return (jrf.RadeFeaturesConfig(
                render=JOpts(backend=backend, pallas_interpret=pallas,
                             **OPTS), **kw),
            trf.RadeFeaturesConfig(render=TOpts(backend=backend, **OPTS),
                                   **kw))


@pytest.fixture(scope="module")
def scene():
    p, K, c2w = numpy_scene(N, seed=21, width=SIZE, height=SIZE)
    rng = np.random.default_rng(22)
    p["distill_features"] = rng.normal(size=(N, LATENT)).astype(np.float32)
    image = rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    gt = {k: rng.normal(size=d).astype(np.float32) for k, d in DIMS}
    return p, K, c2w, image, gt, jax_decoder(seed=23)


def jax_loss(scene, backend):
    p, K, c2w, image, gt, dec = scene
    jcfg, _ = configs(backend)
    jcam, _ = both_cameras(K, c2w, SIZE, SIZE)
    alive = jnp.ones(N, bool)
    sink_shape = jrast.pallas_sink_shape if backend == "pallas" \
        else jrast.absgrad_sink_shape

    @jax.jit
    def value_and_grad(params):
        def loss_fn(params):
            sink = jnp.zeros(sink_shape(SIZE, SIZE, N, jcfg.render))
            outputs, _ = jrf.get_outputs(
                params, alive, jcam, STEP, jcfg, training=True,
                compute_error_maps=True, absgrad_sink=sink)
            loss, ldict = jrf.get_loss(
                outputs, jnp.asarray(image),
                {k: jnp.asarray(v) for k, v in gt.items()}, params, alive,
                STEP, jcfg, reg_active=True)
            return loss, ldict

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    params = {k: jnp.asarray(v) for k, v in p.items()}
    params["decoder"] = {k: jnp.asarray(v) for k, v in dec.items()}
    return value_and_grad(params)


def port_loss(scene, backend):
    p, K, c2w, image, gt, dec = scene
    _, tcfg = configs(backend)
    _, tcam = both_cameras(K, c2w, SIZE, SIZE)
    alive = torch.ones(N, dtype=torch.bool)
    params = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(p, device="cpu").items()}
    decoder = tdec.decoder_from_numpy(dec, device="cpu")
    sink_shape = trast.pallas_sink_shape if backend == "pallas" \
        else trast.absgrad_sink_shape
    sink = torch.zeros(sink_shape(SIZE, SIZE, N, tcfg.render),
                       requires_grad=True)
    outputs, _ = trf.get_outputs(params, alive, tcam, STEP, tcfg,
                                 training=True, compute_error_maps=True,
                                 absgrad_sink=sink)
    loss, ldict = trf.get_loss(
        outputs, torch.from_numpy(image),
        {k: torch.from_numpy(v) for k, v in gt.items()}, params, decoder,
        alive, STEP, tcfg, reg_active=True)
    dtensors = tdec.decoder_tensors(decoder)
    grads = torch.autograd.grad(loss, list(params.values())
                                + list(dtensors.values()), allow_unused=True)
    gp = {k: g for k, g in zip(params, grads[:len(params)])
          if params[k].numel()}
    gd = {k: tdec.jax_layout(k, g.numpy())
          for k, g in zip(dtensors, grads[len(params):])}
    return loss, ldict, gp, gd


@pytest.fixture(scope="module", params=["xla", "pallas"])
def losses_both(request, scene):
    return jax_loss(scene, request.param), port_loss(scene, request.param)


def test_feature_loss_matches(losses_both):
    ((jloss, jdict), _), (tloss, tdict, _, _) = losses_both
    assert set(tdict) == set(jdict)
    assert float(jdict["features_loss"]) > 0
    for k in jdict:
        np.testing.assert_allclose(float(tdict[k].detach()),
                                   float(jdict[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)


def test_feature_gradients_match(losses_both):
    (_, jgrads), (_, _, gp, gd) = losses_both
    jdecg = jgrads.pop("decoder")
    jgrads = {k: v for k, v in jgrads.items() if v.size}
    assert set(gp) == set(jgrads) and set(gd) == set(jdecg)
    for k, g in gp.items():
        ref = np.asarray(jgrads[k])
        assert np.abs(ref).max() > 0, k
        assert_grad_close(g.numpy(), ref, k)
    for k, g in gd.items():
        ref = np.asarray(jdecg[k])
        assert np.abs(ref).max() > 0, k
        assert_grad_close(g, ref, f"decoder {k}")


def test_similarity_map_and_query_vertices_match(scene):
    """On the port's render of the scene, handed to both as numpy."""
    p, K, c2w, _, _, dec = scene
    jcfg, tcfg = configs("xla")
    _, tcam = both_cameras(K, c2w, SIZE, SIZE)
    rng = np.random.default_rng(24)
    emb = rng.normal(size=(4, 16))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(
        np.float32)
    decoder = tdec.decoder_from_numpy(dec, device="cpu")
    verts = rng.normal(size=(30, LATENT)).astype(np.float32)
    with torch.no_grad():
        tout, _ = trf.get_outputs(params_from_numpy(p, device="cpu"),
                                  torch.ones(N, dtype=torch.bool), tcam, STEP,
                                  tcfg, training=False)
        got = trf.similarity_map(decoder, tout, torch.from_numpy(emb), 2,
                                 tcfg)
        qv = trf.query_vertices(decoder, torch.from_numpy(verts),
                                torch.from_numpy(emb), 2, tcfg)
    jout = {k: jnp.asarray(tout[k].numpy()) for k in ("rgb", "features")}
    ref = jrf.similarity_map({"decoder": dec}, jout, jnp.asarray(emb), 2,
                             jcfg)
    assert tuple(got.shape) == (SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    ref_qv = jrf.query_vertices(dec, jnp.asarray(verts), jnp.asarray(emb), 2,
                                jcfg)
    np.testing.assert_allclose(qv.numpy(), np.asarray(ref_qv), rtol=1e-5,
                               atol=1e-6)


def test_init_feature_params():
    _, tcfg = configs("xla")
    p = params_from_numpy(numpy_scene(8)[0], device="cpu")
    out, dec = trf.init_feature_params(p, tcfg,
                                       torch.Generator().manual_seed(0))
    assert tuple(out["distill_features"].shape) == (8, LATENT)
    assert float(out["distill_features"].abs().max()) == 0.0
    assert "decoder" not in out
    assert list(dec.branches) == sorted(dict(DIMS))


def test_distill_features_rows_follow_refine_grow_and_reset():
    """``distill_features`` rows are duplicated, split, culled, grown and
    left alone by the opacity reset as JAX's are (the JAX table also holds
    the decoder subtree, which its refinement skips); ``zero_opt_rows``
    leaves the decoder's moments alone even where a decoder tensor has as
    many rows as the capacity."""
    p, alive, state = table(150, seed=5)
    p["distill_features"] = np.random.default_rng(6).normal(
        size=(CAP, LATENT)).astype(np.float32)
    got, ref = refine_both(p, alive, state)
    assert_refine_match(got, ref)
    assert int(got.n_dup) > 0 and int(got.n_split) > 0
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["decoder"] = jax_decoder()
    jgrown, _ = jgauss.grow_capacity(jp, jnp.asarray(alive), 2 * CAP)
    tgrown, _ = tgauss.grow_capacity(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(alive), 2 * CAP)
    np.testing.assert_array_equal(tgrown["distill_features"].numpy(),
                                  np.asarray(jgrown["distill_features"]))
    jreset = jstrategy.reset_opacity(jp, jstrategy.StrategyConfig())
    treset = tstrategy.reset_opacity(
        {k: torch.from_numpy(v) for k, v in p.items()},
        tstrategy.StrategyConfig())
    np.testing.assert_array_equal(treset["distill_features"].numpy(),
                                  np.asarray(jreset["distill_features"]))
    np.testing.assert_allclose(treset["opacities"].numpy(),
                               np.asarray(jreset["opacities"]), rtol=1e-6)

    dec = tdec.TwoLayerDecoder(LATENT, CAP, {"a": (4, 1, 1)}, device="cpu")
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()}
    opt, _ = toptim.make_optimizer(
        {**params, "decoder": list(dec.parameters())},
        toptim.RADE_FEATURES_GROUPS)
    for x in [*params.values(), *dec.parameters()]:
        x.grad = torch.ones_like(x)
    opt.step()
    before = [opt.state[x]["exp_avg"].clone() for x in dec.parameters()]
    assert dec.hidden.bias.shape[0] == CAP
    tstrategy.zero_opt_rows(opt, got.written)
    for x, b in zip(dec.parameters(), before):
        assert torch.equal(opt.state[x]["exp_avg"], b)
    written = got.written.numpy()
    assert not opt.state[params["distill_features"]]["exp_avg"].numpy()[
        written].any()


# ------------------------------------------------------ three trainer steps
TRAIN_DIMS = (("clip-vit", (16, 4, 4)), ("dinov2", (8, 4, 4)))


def trainer_scene():
    p, K, c2w = numpy_scene(N, seed=31, width=48, height=48)
    rng = np.random.default_rng(32)
    p["distill_features"] = (0.3 * rng.normal(size=(N, LATENT))).astype(
        np.float32)
    cams = []
    for i in range(2):
        c = c2w.copy()
        c[:3, 3] += np.float32(0.1 * i)
        cams.append((K, c))
    images = [rng.uniform(0, 1, (48, 48, 3)).astype(np.float32)
              for _ in cams]
    feats = [{k: rng.normal(size=d).astype(np.float32) for k, d in TRAIN_DIMS}
             for _ in cams]
    return p, cams, images, feats, jax_decoder(seed=33, dims=TRAIN_DIMS)


def trainer_configs(reg_from=1):
    kw = dict(background="black", feature_dims=TRAIN_DIMS,
              regularization_from_iter=reg_from)
    return (JConfig(model=jrf.RadeFeaturesConfig(render=JOpts(**OPTS), **kw),
                    strategy=jstrategy.StrategyConfig(
                        warmup_length=NO_REFINE)),
            TrainerConfig(model=trf.RadeFeaturesConfig(render=TOpts(**OPTS),
                                                       **kw),
                          strategy=tstrategy.StrategyConfig(
                              warmup_length=NO_REFINE)))


def test_three_trainer_steps_with_features_match_jax():
    p, cams, images, feats, dec = trainer_scene()
    jconf, tconf = trainer_configs()
    both = [both_cameras(K, c, 48, 48) for K, c in cams]
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    jparams["decoder"] = {k: jnp.asarray(v) for k, v in dec.items()}
    jtr = JTrainer(jconf, [j for j, _ in both], images, jparams,
                   jnp.ones(N, bool), groups=joptim.RADE_FEATURES_GROUPS,
                   features=feats)
    ttr = Trainer(tconf, [t for _, t in both], images,
                  params_from_numpy(p, device="cpu"),
                  torch.ones(N, dtype=torch.bool), features=feats,
                  decoder=tdec.decoder_from_numpy(dec, device="cpu"),
                  device="cpu")
    assert set(ttr.groups) == set(joptim.RADE_FEATURES_GROUPS)
    for _ in range(3):
        jtr.train_one_step()
        ttr.train_one_step()
    for jh, th in zip(jtr.history, ttr.history):
        assert set(th) == set(jh)
        assert th["nonfinite_grad"] == 0
        for k in ("loss", "rgb_loss", "features_loss", "psnr"):
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-3, err_msg=k)
    assert "depth_normal_loss" in ttr.history[1]
    # The decoder moved, and alike in both.
    got = tdec.decoder_to_numpy(ttr.decoder)
    for k, v in jtr.params["decoder"].items():
        assert not np.array_equal(got[k], dec[k]), k
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_features_are_checked():
    p, cams, images, feats, dec = trainer_scene()
    _, tconf = trainer_configs()
    tcams = [both_cameras(K, c, 48, 48)[1] for K, c in cams]
    args = (tcams, images, params_from_numpy(p, device="cpu"),
            torch.ones(N, dtype=torch.bool))
    decoder = tdec.decoder_from_numpy(dec, device="cpu")
    with pytest.raises(ValueError, match="come together"):
        Trainer(tconf, *args, features=feats, device="cpu")
    bad = [dict(f, dinov2=f["dinov2"][:, :2]) for f in feats]
    with pytest.raises(ValueError, match="feature_dims"):
        Trainer(tconf, *args, features=bad, decoder=decoder, device="cpu")
    plain = dataclasses.replace(
        tconf, model=trf.rade_gs.RadeGSConfig(render=TOpts(**OPTS)))
    with pytest.raises(ValueError, match="RadeFeaturesConfig"):
        Trainer(plain, *args, features=feats, decoder=decoder, device="cpu")

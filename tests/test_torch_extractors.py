"""The port's extractors, tokenizer and feature datamanager against the JAX
package's, on the CPU.

``_prep_image`` and ``_resize_chw`` within rtol 3e-4 / atol 3e-5; the
DINOv2 and MaskCLIP extractors on the same weights file (small widths,
written from JAX's ``init_*``) within the same tolerance, and the text
tower over the tokenizer's ids; ``HashProjectionExtractor`` and the
tokenizer's ids (on a small synthetic BPE file) exactly.  A feature cache
written by either package's ``FeatureDatamanager`` is read by the other's
under the same file name.  The offline fallbacks draw their weights and
text vectors from ``torch.Generator``s, so only their properties are held:
unit norm, the same vector for the same text, another for another.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.data.datamanager import \
    FullImageDatamanager as JFullImage
from collab_splats_tpu.features import clip_tokenizer as jtok
from collab_splats_tpu.features import datamanager as jdm
from collab_splats_tpu.features import extractors as jext
from collab_splats_tpu.features import vit as jvit
from collab_splats_tpu_torch.data.datamanager import \
    FullImageDatamanager as TFullImage
from collab_splats_tpu_torch.features import clip_tokenizer as ttok
from collab_splats_tpu_torch.features import datamanager as tdm
from collab_splats_tpu_torch.features import extractors as text

torch.set_num_threads(2)
TOL = dict(rtol=3e-4, atol=3e-5)


def rgb(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


@pytest.fixture
def fresh_caches():
    """Both packages' cached default extractors and tokenizer, cleared
    before and after (they are per process)."""
    def clear():
        for mod in (jext, text):
            mod._default_extractor.cache_clear()
        for mod in (jtok, ttok):
            mod.get_tokenizer.cache_clear()
    clear()
    yield
    clear()


def save_npz(path, params):
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return str(path)


@pytest.mark.parametrize("hw,res,patch,mean", [
    ((100, 140), 64, 14, (0.5, 0.5, 0.5)),
    ((37, 61), 90, 14, (0.485, 0.456, 0.406)),   # upsampled, snapped
    ((72, 128), 56, 8, (0.1, 0.2, 0.3)),          # already patch multiples
], ids=["down", "up", "exact"])
def test_prep_image_matches_jax(hw, res, patch, mean):
    img = rgb(*hw)
    std = (0.229, 0.224, 0.225)
    ref, rph, rpw = jext._prep_image(img, res, patch, mean, std)
    got, ph, pw = text._prep_image(img, res, patch, mean, std, "cpu")
    assert (ph, pw) == (rph, rpw)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_hash_projection_is_bit_identical():
    img = rgb(60, 90, seed=1)
    ref = jext.HashProjectionExtractor()
    got = text.HashProjectionExtractor()
    np.testing.assert_array_equal(got(img).numpy(), ref(img))
    texts = ["a chair", "a table", "object"]
    np.testing.assert_array_equal(got.encode_text(texts).numpy(),
                                  ref.encode_text(texts))


def test_registry_matches_jax():
    assert text.available_extractors() == jext.available_extractors()
    with pytest.raises(ValueError, match="Unknown extractor"):
        text.get_extractor("nope")
    a = text.get_extractor("hash-proj")
    assert text.get_extractor("hash-proj", device="cpu") is \
        text.get_extractor("hash-proj", device=torch.device("cpu"))
    assert isinstance(a, text.HashProjectionExtractor)


def bpe_file(tmp_path):
    """A small merges file in the CLIP vocabulary's format."""
    merges = ["#version: 0.2", "t h", "th e</w>", "c h", "a i", "ai r</w>",
              "ch air</w>", "t a", "ta b", "l e</w>", "tab le</w>", "o b",
              "j e", "c t</w>"]
    path = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges))
    return path


def test_tokenizer_ids_match_jax(tmp_path):
    path = str(bpe_file(tmp_path))
    ref, got = jtok.ClipTokenizer(path), ttok.ClipTokenizer(path)
    for t in ["the chair", "A  Table!", "object 42", "café_chair's",
              " ".join(["the"] * 90)]:
        assert got.encode(t) == ref.encode(t)
        assert got.encode(t, context_length=12) == \
            ref.encode(t, context_length=12)


def test_dinov2_extractor_matches_jax(tmp_path):
    params = jvit.init_dinov2_params(jax.random.PRNGKey(3), dim=64,
                                     n_blocks=2, grid=4)
    params = {k: (jnp.full_like(v, 0.2) if k.endswith((".ls1", ".ls2"))
                  else v) for k, v in params.items()}
    path = save_npz(tmp_path / "dinov2_vits14.npz", params)
    kw = dict(feature_dim=64, num_heads=4, resolution=70, weights_npz=path)
    ref = jext.DINOv2Extractor(**kw)
    got = text.DINOv2Extractor(**kw, device="cpu")
    assert got.pretrained and ref.pretrained
    img = rgb(90, 130, seed=2)
    want = ref(img)
    out = got(img)
    assert tuple(out.shape) == want.shape == (64, 3, 5)
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.fixture
def clip_weights(tmp_path):
    params = {
        **jvit.init_clip_visual_params(jax.random.PRNGKey(4), dim=64,
                                       n_blocks=2, embed_dim=32, grid=4),
        **jvit.init_clip_text_params(jax.random.PRNGKey(5), dim=64,
                                     n_blocks=2, vocab=600, context=77,
                                     embed_dim=32),
    }
    return save_npz(tmp_path / "clip_vitl14_336.npz", params)


def test_maskclip_extractor_and_text_tower_match_jax(
        tmp_path, monkeypatch, fresh_caches, clip_weights):
    bpe_file(tmp_path)
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(tmp_path))
    kw = dict(feature_dim=32, resolution=56)
    ref = jext.MaskCLIPExtractor(**kw)
    got = text.MaskCLIPExtractor(**kw, device="cpu")
    assert got.pretrained and got.feature_dim == 32
    img = rgb(50, 75, seed=3)
    want = ref(img)
    out = got(img)
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    texts = ["the chair", "a table"]
    np.testing.assert_allclose(got.encode_text(texts).numpy(),
                               ref.encode_text(texts), **TOL)


def test_offline_fallbacks_keep_their_properties(fresh_caches):
    ex = text.get_extractor("clip-vit", device="cpu")
    assert not ex.pretrained
    emb = ex.encode_text(["a chair", "a table", "a chair"])
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=1).numpy(),
                               1.0, rtol=1e-6)
    assert torch.equal(emb[0], emb[2]) and not torch.equal(emb[0], emb[1])
    assert ex is text.get_extractor("clip-vit", device="cpu")
    f = text.DINOv2Extractor(resolution=70, device="cpu")(rgb(40, 60))
    assert f.shape[0] == 384 and torch.isfinite(f).all()


def test_resize_chw_matches_jax():
    feat = np.random.default_rng(4).normal(size=(16, 41, 73)).astype(
        np.float32)
    ref = jdm._resize_chw(feat, 64)
    got = tdm._resize_chw(torch.from_numpy(feat), 64)
    assert tuple(got.shape) == ref.shape == (16, 35, 64)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    small = torch.from_numpy(feat[:, :32, :57])
    assert tdm._resize_chw(small, 64) is small


def both_bases(n=3):
    imgs = [(rgb(48, 80, seed=10 + i) * 255).astype(np.uint8)
            for i in range(n)]
    return (JFullImage([None] * n, [], imgs, []),
            TFullImage([None] * n, [], imgs, []))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_cache_is_read_by_the_other_package(tmp_path, writer,
                                                    fresh_caches):
    jbase, tbase = both_bases()
    cfg = dict(feature_type="hash-proj", extractors=("hash-proj",),
               final_resolution=8, cache_dir=str(tmp_path))
    names = ["a.png", "b.png", "c.png"]
    if writer == "jax":
        first = jdm.FeatureDatamanager(jbase, jdm.FeatureDatamanagerConfig(
            **cfg), names)
        first_maps = [fm["hash-proj"] for fm in first.train_features]
    else:
        first = tdm.FeatureDatamanager(tbase, tdm.FeatureDatamanagerConfig(
            **cfg), names, device="cpu")
        first_maps = [fm["hash-proj"].numpy() for fm in first.train_features]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [first._cache_path().name]
    # The other package reads the file (and would write no other).
    if writer == "jax":
        second = tdm.FeatureDatamanager(tbase, tdm.FeatureDatamanagerConfig(
            **cfg), names, device="cpu")
        maps = [fm["hash-proj"].numpy() for fm in second.train_features]
    else:
        second = jdm.FeatureDatamanager(jbase, jdm.FeatureDatamanagerConfig(
            **cfg), names)
        maps = [fm["hash-proj"] for fm in second.train_features]
    assert second._cache_path() == first._cache_path()
    for a, b in zip(maps, first_maps):
        np.testing.assert_array_equal(a, b)
    assert second.metadata() == first.metadata()
    assert second.feature_dims["hash-proj"] == (64, 4, 8)
    assert sorted(p.name for p in tmp_path.iterdir()) == files


def test_feature_datamanager_matches_jax_without_cache(fresh_caches):
    jbase, tbase = both_bases(2)
    cfg = dict(feature_type="hash-proj", extractors=("hash-proj",),
               final_resolution=5)
    ref = jdm.FeatureDatamanager(jbase, jdm.FeatureDatamanagerConfig(**cfg))
    got = tdm.FeatureDatamanager(tbase, tdm.FeatureDatamanagerConfig(**cfg),
                                 device="cpu")
    for a, b in zip(got.train_features, ref.train_features):
        np.testing.assert_allclose(a["hash-proj"].numpy(), b["hash-proj"],
                                   **TOL)
    assert got.feature_dims == ref.feature_dims
    cam, batch, idx = got.next_train(0, np.random.RandomState(0))
    assert batch["features_dict"] is got.train_features[idx]
    assert got.text_encoder() is got._extractors["hash-proj"]


def test_pretrained_variant_names_the_same_cache(tmp_path, monkeypatch,
                                                 fresh_caches):
    params = jvit.init_dinov2_params(jax.random.PRNGKey(6), dim=64,
                                     n_blocks=1, grid=4)
    wdir = tmp_path / "w"
    wdir.mkdir()
    save_npz(wdir / "dinov2_vits14.npz", params)
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(wdir))
    jbase, tbase = both_bases(1)
    cfg = dict(feature_type="dinov2", extractors=("dinov2",),
               cache_dir=str(tmp_path / "cache"))
    ref = jdm.FeatureDatamanager.__new__(jdm.FeatureDatamanager)
    ref.feature_config = jdm.FeatureDatamanagerConfig(**cfg)
    ref._extractors = {"dinov2": jext.get_extractor("dinov2")}
    ref.image_names = ["0"]
    got = tdm.FeatureDatamanager.__new__(tdm.FeatureDatamanager)
    got.feature_config = tdm.FeatureDatamanagerConfig(**cfg)
    got._extractors = {"dinov2": text.get_extractor("dinov2", device="cpu")}
    got.image_names = ["0"]
    assert got._extractors["dinov2"].pretrained
    assert got._extractors["dinov2"].feature_dim == 64
    assert got._cache_path() == ref._cache_path()

"""The port's ViT towers and resize helper against the JAX package's, on
the CPU.

The same seeded parameters (JAX's ``init_*`` at small widths, carried
across by ``vit.params_from_numpy``) and inputs go through
``collab_splats_tpu.features.vit`` and ``collab_splats_tpu_torch.features
.vit``: DINOv2, the MaskCLIP visual tower and the CLIP text tower within
rtol 3e-4 / atol 3e-5 (tests/test_weight_converters.py:243), the bicubic
position table against JAX's written-out matrix.  The resize helper is
held to ``jax.image.resize`` in both antialias modes, up and down, on odd
sizes and other axes, within 1e-6 of max|ref| (looser only where float32
sample positions near 127 and 512 round: see the note at the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.features import vit as jvit
from collab_splats_tpu_torch.features import vit as tvit
from collab_splats_tpu_torch.features.decoder import resize_bilinear

torch.set_num_threads(2)
TOL = dict(rtol=3e-4, atol=3e-5)
DIM, HEADS, BLOCKS, PATCH = 64, 4, 2, 14


def carried(params):
    """JAX parameters as numpy, and the port's copy of them on the CPU."""
    arrays = {k: np.asarray(v) for k, v in params.items()}
    return arrays, tvit.params_from_numpy(arrays, device="cpu")


def image(h, w, seed=0):
    return np.random.default_rng(seed).normal(size=(h, w, 3)).astype(
        np.float32)


# Within 1e-6 of max|ref|, except where float32 sample positions near n
# carry up to half an ulp of n of rounding, which XLA's fused multiply-add
# rounds otherwise than numpy's two steps: the rel-pos table (positions near
# 127) within 1e-5, the extractor's and SAM's sizes (near 512 and 1024)
# within 1e-4.
@pytest.mark.parametrize("shape,size,axes,antialias,tol", [
    ((37, 65, 3), (11, 29), (0, 1), True, 1e-6),    # odd sizes, down
    ((37, 65, 3), (11, 29), (0, 1), False, 1e-6),
    ((9, 7, 2), (20, 3), (0, 1), False, 1e-6),      # one axis up, one down
    ((27, 8), (127, 8), (0, 1), True, 1e-5),        # the rel-pos table
    ((3, 2, 64, 64), (256, 256), (2, 3), True, 1e-6),   # mask logits, up
    ((2, 1, 256, 256), (45, 80), (2, 3), True, 1e-6),   # and down
    ((96, 41, 73), (35, 64), (1, 2), True, 1e-6),   # a feature map's edge
    ((720, 1280, 3), (576, 1024), (0, 1), True, 1e-4),  # _prep_image 1
    ((576, 1024, 3), (574, 1022), (0, 1), False, 1e-4),  # _prep_image 2
    ((1, 1, 256, 256), (1024, 1024), (2, 3), True, 1e-4),  # SAM's upscale
], ids=["odd-down-aa", "odd-down", "odd-mixed", "rel-pos", "masks-up",
        "masks-down", "chw", "prep-aa", "prep-snap", "sam-1024"])
def test_resize_matches_jax_image_resize(shape, size, axes, antialias, tol):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    out = list(shape)
    out[axes[0]], out[axes[1]] = size
    ref = np.asarray(jax.image.resize(jnp.asarray(x), tuple(out), "linear",
                                      antialias=antialias))
    got = resize_bilinear(torch.from_numpy(x), size, axes=axes,
                          antialias=antialias).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("grid,hw", [(24, (41, 73)), (37, (32, 57)),
                                     (5, (3, 7)), (4, (4, 4))],
                         ids=["clip-1024", "dinov2-800", "small", "kept"])
def test_interpolate_pos_embed_matches_jax_matrix(grid, hw):
    pos = np.random.default_rng(2).normal(
        size=(1 + grid * grid, 16)).astype(np.float32)
    ref = np.asarray(jvit.interpolate_pos_embed(jnp.asarray(pos), hw))
    got = tvit.interpolate_pos_embed(torch.from_numpy(pos), hw).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_layer_norm_and_quick_gelu():
    x = np.random.default_rng(3).normal(size=(7, 32)).astype(np.float32)
    s = np.random.default_rng(4).normal(size=32).astype(np.float32)
    b = np.random.default_rng(5).normal(size=32).astype(np.float32)
    for eps in (1e-6, 1e-5):
        np.testing.assert_allclose(
            tvit.layer_norm(*map(torch.from_numpy, (x, s, b)), eps).numpy(),
            np.asarray(jvit.layer_norm(x, s, b, eps)), **TOL)
    np.testing.assert_allclose(tvit.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jvit.quick_gelu(x)), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_jax(causal):
    arrays, params = carried(jvit.init_dinov2_params(
        jax.random.PRNGKey(0), DIM, 1, PATCH, grid=2))
    x = np.random.default_rng(6).normal(size=(9, DIM)).astype(np.float32)
    ref = jvit.attention(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                          arrays.items()},
                         "blocks.0.attn", HEADS, causal=causal)
    got = tvit.attention(torch.from_numpy(x), params, "blocks.0.attn", HEADS,
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def layer_scaled(params, value=0.3):
    """LayerScale at 0.3 instead of the init's 1e-5, so the blocks count."""
    return {k: (jnp.full_like(v, value) if k.endswith((".ls1", ".ls2"))
                else v) for k, v in params.items()}


@pytest.mark.parametrize("hw", [(5, 5), (3, 7)], ids=["grid", "interp"])
def test_dinov2_forward_matches_jax(hw):
    jp = layer_scaled(jvit.init_dinov2_params(jax.random.PRNGKey(1), DIM,
                                              BLOCKS, PATCH, grid=5))
    arrays, params = carried(jp)
    img = image(hw[0] * PATCH, hw[1] * PATCH)
    ref = np.asarray(jvit.dinov2_forward(jp, jnp.asarray(img), HEADS, PATCH))
    got = tvit.dinov2_forward(params, torch.from_numpy(img), HEADS, PATCH)
    assert got.shape == (hw[0] * hw[1], DIM)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("hw", [(4, 4), (3, 6)], ids=["grid", "interp"])
def test_maskclip_forward_matches_jax(hw):
    jp = jvit.init_clip_visual_params(jax.random.PRNGKey(2), DIM, BLOCKS,
                                      PATCH, embed_dim=48, grid=4)
    _, params = carried(jp)
    img = image(hw[0] * PATCH, hw[1] * PATCH, seed=7)
    ref = np.asarray(jvit.maskclip_forward(jp, jnp.asarray(img), HEADS,
                                           PATCH))
    got = tvit.maskclip_forward(params, torch.from_numpy(img), HEADS, PATCH)
    assert got.shape == (hw[0] * hw[1], 48)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_clip_text_forward_matches_jax():
    jp = jvit.init_clip_text_params(jax.random.PRNGKey(3), 32, BLOCKS,
                                    vocab=64, context=12, embed_dim=48)
    _, params = carried(jp)
    tokens = np.array([5, 17, 30, 63, 0, 0, 0, 0])   # 63, the max, is EOT
    ref = np.asarray(jvit.clip_text_forward(jp, jnp.asarray(tokens), 2))
    got = tvit.clip_text_forward(params, torch.from_numpy(tokens), 2)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["dinov2", "clip_visual", "clip_text"])
def test_init_params_have_jax_names_and_shapes(name):
    kw = {"dinov2": dict(dim=32, n_blocks=2, grid=4),
          "clip_visual": dict(dim=32, n_blocks=2, grid=4, embed_dim=16),
          "clip_text": dict(dim=32, n_blocks=2, vocab=40, context=9,
                            embed_dim=16)}[name]
    ref = getattr(jvit, f"init_{name}_params")(jax.random.PRNGKey(0), **kw)
    got = getattr(tvit, f"init_{name}_params")(
        torch.Generator().manual_seed(0), device="cpu", **kw)
    assert {k: tuple(np.shape(v)) for k, v in ref.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    again = getattr(tvit, f"init_{name}_params")(
        torch.Generator().manual_seed(0), device="cpu", **kw)
    assert all(torch.equal(got[k], again[k]) for k in got)

"""The port's SAM modules and predictor against the JAX package's, on the
CPU.

The prompt encoder and the two-way decoder take the parameters
``scripts/convert_sam.py`` makes of a synthetic state dict with the
official segment-anything names (tests/test_sam.py); the image encoder
takes a narrow one (width 32, a windowed and a global block, rel-pos
tables that the global block resizes) in the converter's layout.  Both
packages get the same numpy parameters and inputs; outputs within rtol
3e-4 / atol 3e-5 (tests/test_weight_converters.py:243).  The predictor
runs ``set_image`` and the box, point and automatic paths on both; masks
are logits > 0, so pixels whose logit lies within the tolerance of 0 may
flip, and none else.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.features import sam as JS
from collab_splats_tpu.features import sam_predictor as jpred
from collab_splats_tpu_torch.features import sam as TS
from collab_splats_tpu_torch.features import sam_predictor as tpred
from collab_splats_tpu_torch.features.vit import params_from_numpy
from test_sam import _synthetic_sam_sd

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from convert_sam import convert_sam  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=3e-4, atol=3e-5)
DIM, HEADS = 32, 2


def narrow_encoder(seed=0):
    """An image encoder in the converter's layout: width 32, block 0
    windowed (14), block 1 global with 27-long rel-pos tables (resized to
    127, as a checkpoint's would be for another input size)."""
    rng = np.random.default_rng(seed)
    g = lambda *s: (0.05 * rng.normal(size=s)).astype(np.float32)  # noqa
    p = {"enc.patch_embed.w": g(16 * 16 * 3, DIM),
         "enc.patch_embed.b": g(DIM), "enc.pos_embed": g(64, 64, DIM),
         "enc.n_blocks": np.asarray(2), "enc.window": np.asarray(14),
         "enc.num_heads": np.asarray(HEADS),
         "enc.global_blocks": np.asarray([1])}
    for i in range(2):
        pre = f"enc.blocks.{i}"
        p.update({
            f"{pre}.ln1.scale": 1 + g(DIM), f"{pre}.ln1.bias": g(DIM),
            f"{pre}.ln2.scale": 1 + g(DIM), f"{pre}.ln2.bias": g(DIM),
            f"{pre}.attn.qkv.w": 4 * g(DIM, 3 * DIM),
            f"{pre}.attn.qkv.b": g(3 * DIM),
            f"{pre}.attn.proj.w": 4 * g(DIM, DIM),
            f"{pre}.attn.proj.b": g(DIM),
            f"{pre}.attn.rel_pos_h": 10 * g(27, DIM // HEADS),
            f"{pre}.attn.rel_pos_w": 10 * g(27, DIM // HEADS),
            f"{pre}.mlp.w1": 4 * g(DIM, 4 * DIM), f"{pre}.mlp.b1": g(4 * DIM),
            f"{pre}.mlp.w2": 4 * g(4 * DIM, DIM), f"{pre}.mlp.b2": g(DIM)})
    p.update({"enc.neck.conv1.w": 4 * g(DIM, 256),
              "enc.neck.ln1.scale": 1 + g(256), "enc.neck.ln1.bias": g(256),
              "enc.neck.conv2.w": g(3, 3, 256, 256),
              "enc.neck.ln2.scale": 1 + g(256), "enc.neck.ln2.bias": g(256)})
    return p


@pytest.fixture(scope="module")
def arrays():
    out = convert_sam(_synthetic_sam_sd(n_blocks=1), decoder_only=True)
    out.update(narrow_encoder())
    return out


@pytest.fixture(scope="module")
def both(arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            params_from_numpy(arrays, device="cpu"))


@pytest.mark.parametrize("q,k,n", [(14, 14, 27), (64, 64, 27), (64, 64, 127),
                                   (5, 9, 17)],
                         ids=["window", "resized", "global", "uneven"])
def test_rel_pos_bias_matches_jax(q, k, n):
    table = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    ref = np.asarray(JS._rel_pos_bias(q, k, jnp.asarray(table)))
    got = TS._rel_pos_bias(q, k, torch.from_numpy(table)).numpy()
    assert got.shape == ref.shape
    # A resized table: the resize's float32 sample positions near 127
    # round otherwise under XLA (tests/test_torch_vit.py).
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(table).max())


def test_encoder_matches_jax(both):
    jp, tp = both
    img = np.random.default_rng(2).normal(size=(1024, 1024, 3)).astype(
        np.float32)
    ref = np.asarray(JS.sam_encoder_forward(jp, jnp.asarray(img)))
    got = TS.sam_encoder_forward(tp, torch.from_numpy(img)).numpy()
    assert got.shape == (256, 64, 64)
    np.testing.assert_allclose(got, ref, **TOL)


def test_prompts_match_jax(both):
    jp, tp = both
    np.testing.assert_allclose(TS.dense_pe(tp).numpy(),
                               np.asarray(JS.dense_pe(jp)), **TOL)
    boxes = np.array([[100.0, 200.0, 500.0, 600.0], [0, 0, 1024, 1024]],
                     np.float32)
    np.testing.assert_allclose(
        TS.encode_boxes(tp, torch.from_numpy(boxes)).numpy(),
        np.asarray(JS.encode_boxes(jp, jnp.asarray(boxes))), **TOL)
    pts = np.array([[[512.0, 512.0], [3.0, 900.0], [0.0, 0.0]]], np.float32)
    labels = np.array([[1, 0, -1]], np.int32)
    np.testing.assert_allclose(
        TS.encode_points(tp, torch.from_numpy(pts),
                         torch.from_numpy(labels)).numpy(),
        np.asarray(JS.encode_points(jp, jnp.asarray(pts),
                                    jnp.asarray(labels))), **TOL)


@pytest.mark.parametrize("multimask", [False, True])
def test_mask_decoder_matches_jax(both, multimask):
    jp, tp = both
    emb = (0.3 * np.random.default_rng(3).normal(size=(256, 64, 64))).astype(
        np.float32)
    boxes = np.array([[100.0, 200.0, 500.0, 600.0], [10, 10, 90, 60],
                      [0, 0, 1024, 1024]], np.float32)
    rlow, riou = JS.mask_decoder_forward(
        jp, jnp.asarray(emb), JS.dense_pe(jp),
        JS.encode_boxes(jp, jnp.asarray(boxes)), multimask=multimask)
    low, iou = TS.mask_decoder_forward(
        tp, torch.from_numpy(emb), TS.dense_pe(tp),
        TS.encode_boxes(tp, torch.from_numpy(boxes)), multimask=multimask)
    m = 3 if multimask else 1
    assert tuple(low.shape) == (3, m, 256, 256) and tuple(iou.shape) == (3, m)
    np.testing.assert_allclose(low.numpy(), np.asarray(rlow), **TOL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(riou), **TOL)


def test_postprocess_masks_matches_jax():
    low = np.random.default_rng(4).normal(size=(2, 1, 256, 256)).astype(
        np.float32)
    ref = np.asarray(JS.postprocess_masks(jnp.asarray(low), (96, 128),
                                          (768, 1024)))
    got = TS.postprocess_masks(torch.from_numpy(low), (96, 128),
                               (768, 1024)).numpy()
    assert got.shape == (2, 1, 96, 128)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.fixture(scope="module")
def predictors(arrays, tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "sam_vit_b.npz"
    np.savez(path, **arrays)
    ref = jpred.SamBackend(str(path))
    got = tpred.SamBackend(str(path), device="cpu")
    img = (np.random.default_rng(5).uniform(0, 255, (96, 128, 3))
           ).astype(np.uint8)
    ref.set_image(img)
    got.set_image(img)
    return ref, got, img


def assert_masks_match(got, ref, logits):
    """Boolean masks equal except where the logit is within the tolerance
    of 0."""
    near = np.abs(logits) <= 3e-4 * np.abs(logits).max() + 3e-5
    assert not np.any((got != ref) & ~near)


def test_set_image_matches_jax(predictors):
    ref, got, _ = predictors
    assert got._input_hw == ref._input_hw and got._scale == ref._scale
    np.testing.assert_allclose(got._embedding.numpy(),
                               np.asarray(ref._embedding), **TOL)


def test_box_and_point_predictions_match_jax(predictors):
    ref, got, _ = predictors
    boxes = np.array([[10.0, 10.0, 60.0, 60.0], [0, 20, 127, 95]],
                     np.float32)
    rmask, riou = ref.predict_boxes(boxes)
    gmask, giou = got.predict_boxes(boxes)
    np.testing.assert_allclose(giou, riou, **TOL)
    pts = np.array([[30.0, 40.0], [100.0, 80.0]], np.float32)
    rlow, riou = ref.predict_points_low(pts)
    glow, giou = got.predict_points_low(pts)
    np.testing.assert_allclose(glow, rlow, **TOL)
    np.testing.assert_allclose(giou, riou, **TOL)
    rm, _, rlog = ref.predict_points(pts)
    gm, _, glog = got.predict_points(pts)
    np.testing.assert_allclose(glog, rlog, **TOL)
    assert_masks_match(gm, rm, rlog)
    assert gmask.shape == rmask.shape == (2, 96, 128)


def test_segment_boxes_and_auto_segment_match_jax(predictors):
    ref, got, img = predictors
    boxes = np.array([[10.0, 10.0, 60.0, 60.0], [0, 20, 127, 95]])
    for a, b in zip(got.segment_boxes(img, boxes), ref.segment_boxes(img,
                                                                     boxes)):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["predicted_iou"], b["predicted_iou"],
                                   **TOL)
        assert abs(a["area"] - b["area"]) <= 2
    kw = dict(points_per_side=3, pred_iou_thresh=-1e9, stability_thresh=0.0,
              min_area=1)
    ra, ga = ref.auto_segment(img, **kw), got.auto_segment(img, **kw)
    assert len(ga) == len(ra)
    for a, b in zip(ga, ra):
        np.testing.assert_allclose(a["predicted_iou"], b["predicted_iou"],
                                   **TOL)
        assert abs(a["area"] - b["area"]) <= 2

"""The port's YOLOv8 detector against the JAX package's, on the CPU.

A synthetic ultralytics state dict (tests/test_yolo.py: tiny widths, the
real module names, conv + BatchNorm pairs) goes through
``scripts/convert_yolo.py``; both packages load the same arrays.  The raw
head outputs (boxes and class scores, before NMS) within rtol 3e-4 /
atol 3e-5 (tests/test_weight_converters.py:243); NMS, which is numpy in
both, exactly; the detector's letterbox, and its kept boxes from the same
raw outputs (NMS thresholds an IoU, so outputs that agree to float
rounding may keep another box).
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.features import yolo as jyolo
from collab_splats_tpu_torch.features import yolo as tyolo
from collab_splats_tpu_torch.features.vit import params_from_numpy
from test_yolo import make_state_dict

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from convert_yolo import convert_yolov8  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=3e-4, atol=3e-5)


@pytest.fixture(scope="module")
def arrays():
    return convert_yolov8({k: v.numpy() for k, v in
                           make_state_dict().items()})


@pytest.mark.parametrize("hw", [(128, 128), (96, 160)])
def test_forward_matches_jax(arrays, hw):
    img = np.random.default_rng(1).uniform(0, 1, hw + (3,)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    rboxes, rscores = jax.jit(functools.partial(jyolo.yolo_forward, jp))(
        jnp.asarray(img))
    boxes, scores = tyolo.yolo_forward(params_from_numpy(arrays, "cpu"),
                                       torch.from_numpy(img))
    n = sum((hw[0] // s) * (hw[1] // s) for s in tyolo.STRIDES)
    assert tuple(boxes.shape) == (n, 4) and tuple(scores.shape) == (n, 1)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(rboxes), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(rscores), **TOL)


def test_nms_matches_jax_exactly():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 200, (400, 2))
    wh = rng.uniform(2, 60, (400, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 400).astype(np.float32)
    for thresh, max_det in ((0.5, 300), (0.2, 50), (0.95, 1000)):
        np.testing.assert_array_equal(
            tyolo.nms_boxes(boxes, scores, thresh, max_det),
            jyolo.nms_boxes(boxes, scores, thresh, max_det))


def test_detector_matches_jax(arrays, tmp_path, monkeypatch):
    npz = tmp_path / "yolov8_objaware.npz"
    np.savez(npz, **arrays)
    ref = jyolo.ObjectAwareDetector(weights_npz=str(npz), conf=0.3)
    got = tyolo.ObjectAwareDetector(weights_npz=str(npz), conf=0.3,
                                    device="cpu")
    img = (np.random.default_rng(3).uniform(0, 255, (96, 160, 3))
           .astype(np.uint8))
    padded, scale = got.letterbox(img)
    assert tuple(padded.shape) == (384, 640, 3) and scale == 4.0
    # JAX's letterbox, as its __call__ builds it.
    rresized = np.asarray(jax.image.resize(
        jnp.asarray(img.astype(np.float32) / 255.0), (96 * 4, 160 * 4, 3),
        "linear"))
    np.testing.assert_allclose(padded.numpy(), rresized, **TOL)
    # The same raw outputs through both detectors' thresholds and NMS.
    raw = [np.asarray(a) for a in ref._forward(jnp.asarray(rresized))]
    monkeypatch.setattr(tyolo, "yolo_forward", lambda p, x: tuple(
        torch.from_numpy(a.copy()) for a in raw))
    ref._forward = lambda x: tuple(jnp.asarray(a) for a in raw)
    rboxes, rconfs = ref(img)
    boxes, confs = got(img)
    assert len(boxes) > 1 and boxes.dtype == np.float32
    np.testing.assert_array_equal(confs, rconfs)
    np.testing.assert_array_equal(boxes, rboxes)

"""Parity of the port's loss stack with the JAX package, on the CPU.

``ssim``, ``rgb_loss``, ``psnr``, ``depth_normal_loss``,
``scale_regularization`` and ``depth_pair_to_normal`` of both packages take
the same numpy inputs; values agree within rtol 1e-5 (float sums in
another order) and input gradients within the gradient tolerance (rtol
5e-4, atol 5e-5 * max|g|, tests/test_pallas.py:205-206).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core import cameras as jcameras
from collab_splats_tpu.train import losses as jlosses
from collab_splats_tpu_torch.core import cameras as tcameras
from collab_splats_tpu_torch.train import losses as tlosses
from test_torch_core import both_cameras, numpy_scene

torch.set_num_threads(2)
H, W = 40, 56


def images(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


def value_and_grads(jfn, tfn, *arrays):
    """(value, input gradients) of both packages' scalar functions."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts)
    return ((float(tv.detach()), [g.numpy() for g in tg]),
            (float(jv), [np.asarray(g) for g in jg]))


def assert_match(got, ref):
    (tv, tg), (jv, jg) = got, ref
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-7)
    for a, b in zip(tg, jg):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5 * scale)


@pytest.mark.parametrize("name", ["ssim", "rgb_loss", "psnr"])
def test_image_losses_match(name):
    a, b = images(0)
    got, ref = value_and_grads(getattr(jlosses, name),
                               getattr(tlosses, name), a, b)
    assert_match(got, ref)


@pytest.mark.parametrize("shape", [(9, 16), (16, 9), (5, 5)])
def test_rgb_loss_below_the_window_matches(shape):
    """An image with a side under SSIM's 11-pixel window (a 64x36 view at
    downscale 4 is 16x9): JAX's VALID filter is empty, so SSIM and the loss
    are NaN while the gradient is L1's alone; the port raised here."""
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0, 1, shape + (3,)).astype(np.float32)
            for _ in range(2))
    (tv, tg), (jv, jg) = value_and_grads(jlosses.rgb_loss, tlosses.rgb_loss,
                                         a, b)
    assert np.isnan(jv) and np.isnan(tv)
    assert np.isnan(float(tlosses.ssim(torch.from_numpy(a),
                                       torch.from_numpy(b))))
    for x, y in zip(tg, jg):
        assert np.isfinite(y).all()
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-9)


def test_depth_normal_loss_matches():
    rng = np.random.default_rng(1)
    e1 = rng.uniform(0, 2, (H, W, 1)).astype(np.float32)
    e2 = rng.uniform(0, 2, (H, W, 1)).astype(np.float32)
    got, ref = value_and_grads(jlosses.depth_normal_loss,
                               tlosses.depth_normal_loss, e1, e2)
    assert_match(got, ref)


def test_scale_regularization_matches():
    rng = np.random.default_rng(2)
    log_scales = np.log(rng.uniform(0.001, 0.2, (300, 3))).astype(np.float32)
    alive = (rng.uniform(size=300) < 0.8).astype(np.float32)
    got, ref = value_and_grads(
        lambda s: jlosses.scale_regularization(s, jnp.asarray(alive), 10.0),
        lambda s: tlosses.scale_regularization(s, torch.from_numpy(alive),
                                               10.0),
        log_scales)
    assert got[0] > 0.0
    assert_match(got, ref)


def test_depth_pair_to_normal_matches():
    _, K, c2w = numpy_scene(1, width=W, height=H)
    jcam, tcam = both_cameras(K, c2w, W, H)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W]
    d1 = (2.0 + 0.01 * xx + 0.02 * yy
          + 0.01 * rng.normal(size=(H, W))).astype(np.float32)
    d2 = (d1 + 0.05 * rng.normal(size=(H, W))).astype(np.float32)
    w = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    got, ref = value_and_grads(
        lambda a, b: jnp.sum(jcameras.depth_pair_to_normal(jcam, a, b) * w),
        lambda a, b: torch.sum(tcameras.depth_pair_to_normal(tcam, a, b)
                               * torch.from_numpy(w)),
        d1, d2)
    assert_match(got, ref)
    n = tcameras.depth_pair_to_normal(tcam, torch.from_numpy(d1),
                                      torch.from_numpy(d2)).numpy()
    assert n.shape == (2, H, W, 3)
    assert np.all(n[:, 0] == 0) and np.all(n[:, :, -1] == 0)
    np.testing.assert_allclose(
        n, np.asarray(jcameras.depth_pair_to_normal(
            jcam, jnp.asarray(d1), jnp.asarray(d2))), rtol=1e-5, atol=1e-5)

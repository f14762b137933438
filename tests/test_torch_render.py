"""Parity of the port's whole forward render with the JAX package, on the CPU.

``models/rade_gs.py::get_outputs(training=False)`` of both packages renders
one numpy scene, loaded into the port with ``params_from_numpy`` and
``camera_from_numpy``.  rgb, depth, median_depth, normals and accumulation
agree within rtol = atol = 1e-5 (float sums taken in another order by XLA
and ATen); spilled is an integer and agrees exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.cameras import make_camera as jmake_camera
from collab_splats_tpu.core.options import RenderOptions as JOpts
from collab_splats_tpu.models import rade_gs as jrade
from collab_splats_tpu.models.gaussians import pad_to_capacity as jpad
from collab_splats_tpu_torch.core.cameras import camera_from_numpy
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.data.synthetic import look_at_c2w
from collab_splats_tpu_torch.models import rade_gs as trade
from collab_splats_tpu_torch.models.gaussians import (
    pad_to_capacity as tpad,
    params_from_numpy,
)
from test_torch_core import numpy_scene

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
KEYS = ("rgb", "depth", "median_depth", "normals", "accumulation")


def render_both(p, K, c2w, width, height, sh_degree, mode, alive=None,
                crop_box=None, **opts):
    n = p["means"].shape[0]
    alive = np.ones(n, bool) if alive is None else alive
    jcfg = jrade.RadeGSConfig(sh_degree=sh_degree, background="black",
                              render=JOpts(rasterize_mode=mode, **opts))
    tcfg = trade.RadeGSConfig(sh_degree=sh_degree, background="black",
                              render=TOpts(rasterize_mode=mode, **opts))
    jcam = jmake_camera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height,
                        jnp.asarray(c2w))
    tcam = camera_from_numpy(K, c2w, width, height, device="cpu")
    ref, _ = jrade.get_outputs(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(alive), jcam,
        0, jcfg, training=False,
        crop_box=None if crop_box is None else jnp.asarray(crop_box))
    got, _ = trade.get_outputs(
        params_from_numpy(p, device="cpu"), torch.from_numpy(alive), tcam,
        0, tcfg, training=False,
        crop_box=None if crop_box is None else torch.from_numpy(crop_box))
    return got, ref


def assert_outputs_match(got, ref, height, width):
    for k in KEYS:
        a, b = got[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape and a.shape[:2] == (height, width), k
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, err_msg=k, **TOL)
    assert int(got["spilled"]) == int(ref["spilled"])
    acc = got["accumulation"].numpy()
    assert acc.min() >= 0.0 and acc.max() <= 1.0


@pytest.mark.parametrize("sh_degree,mode,width,height", [
    (0, "classic", 128, 96),
    (3, "antialiased", 128, 96),
    (0, "antialiased", 100, 75),
    (3, "classic", 100, 75),
])
def test_get_outputs_matches(sh_degree, mode, width, height):
    p, K, c2w = numpy_scene(2000, seed=5, sh_degree=sh_degree, width=width,
                            height=height)
    got, ref = render_both(p, K, c2w, width, height, sh_degree, mode)
    assert_outputs_match(got, ref, height, width)
    assert (got["accumulation"] > 0).float().mean() > 0.3


def test_capacity_padding_with_alive_mask():
    """Dead capacity rows (padded as the JAX package pads them) render as
    nothing, and small capacities make both packages spill alike."""
    n, cap = 1500, 2000
    p, K, c2w = numpy_scene(n, seed=6, sh_degree=3)
    jp = {k: np.asarray(v) for k, v in
          jpad({k: jnp.asarray(v) for k, v in p.items()}, cap).items()}
    tp = tpad(params_from_numpy(p, device="cpu"), cap)
    for k in p:
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])
    alive = np.arange(cap) < n
    got, ref = render_both(jp, K, c2w, 128, 96, 3, "antialiased",
                           alive=alive, tile_capacity=64,
                           max_intersections=1 << 13)
    assert_outputs_match(got, ref, 96, 128)
    assert int(got["spilled"]) > 0


def test_crop_box():
    p, K, c2w = numpy_scene(2000, seed=7)
    box = np.array([[-0.6, -0.6, -0.6], [0.6, 0.6, 0.6]], np.float32)
    got, ref = render_both(p, K, c2w, 128, 96, 0, "antialiased",
                           crop_box=box)
    assert_outputs_match(got, ref, 96, 128)
    full, _ = render_both(p, K, c2w, 128, 96, 0, "antialiased")
    assert got["accumulation"].sum() < full["accumulation"].sum()


def test_camera_facing_away_renders_zeros():
    p, K, _ = numpy_scene(2000, seed=8)
    c2w = look_at_c2w(np.array([3.0, 0.0, 0.0]), np.array([6.0, 0.0, 0.0]))
    got, ref = render_both(p, K, c2w, 128, 96, 0, "classic")
    assert_outputs_match(got, ref, 96, 128)
    for k in ("rgb", "depth", "median_depth", "accumulation"):
        assert float(got[k].abs().max()) == 0.0, k
    assert int(got["spilled"]) == 0

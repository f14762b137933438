"""Parity of the PyTorch port's core maths with the JAX package, on the CPU.

One scene, drawn with numpy from a seed, goes through the JAX functions and
their counterparts in ``collab_splats_tpu_torch``.  Tolerance rtol = atol =
1e-5: XLA and ATen take float32 sums and contract multiply-adds in
different orders, so the two agree to float rounding, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core import projection as jproj
from collab_splats_tpu.core import sh as jsh
from collab_splats_tpu.core.cameras import make_camera as jmake_camera
from collab_splats_tpu.models import rade_gs as jrade
from collab_splats_tpu_torch.core import projection as tproj
from collab_splats_tpu_torch.core import sh as tsh
from collab_splats_tpu_torch.core.cameras import camera_from_numpy
from collab_splats_tpu_torch.data.synthetic import look_at_c2w
from collab_splats_tpu_torch.models import rade_gs as trade
from collab_splats_tpu_torch.models.gaussians import params_from_numpy

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def numpy_scene(n, seed=0, sh_degree=0, width=128, height=96):
    """Raw parameters [n] and one orbit camera, all numpy float32."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    params = {
        "means": rng.uniform(-1.2, 1.2, (n, 3)),
        "scales": np.log(rng.uniform(0.01, 0.08, (n, 3))),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "opacities": rng.uniform(-2.0, 3.0, (n, 1)),
        "features_dc": rng.uniform(-1.5, 1.5, (n, 3)),
        "features_rest": 0.2 * rng.normal(
            size=(n, (sh_degree + 1) ** 2 - 1, 3)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    c2w = look_at_c2w(np.array([3.0, 0.4, 1.1]), np.zeros(3))
    f = 1.2 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    return params, K, c2w


def both_cameras(K, c2w, width, height):
    jcam = jmake_camera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height,
                        jnp.asarray(c2w))
    tcam = camera_from_numpy(K, c2w, width, height, device="cpu")
    return jcam, tcam


def test_viewmat_matches():
    _, K, c2w = numpy_scene(4)
    jcam, tcam = both_cameras(K, c2w, 128, 96)
    np.testing.assert_allclose(tcam.viewmat().numpy(),
                               np.asarray(jcam.viewmat()), **TOL)


@pytest.mark.parametrize("with_opac", [True, False])
def test_projection_matches_every_field(with_opac):
    p, K, c2w = numpy_scene(1500, seed=1)
    jcam, tcam = both_cameras(K, c2w, 128, 96)
    opac = 1.0 / (1.0 + np.exp(-p["opacities"][:, 0]))
    args = dict(eps2d=0.3, near_plane=0.01, far_plane=1e10)
    ref = jproj.project_gaussians(
        jnp.asarray(p["means"]), jnp.asarray(p["quats"]),
        jnp.exp(jnp.asarray(p["scales"])), jcam.viewmat(), jcam.K, 128, 96,
        opacities=jnp.asarray(opac) if with_opac else None, **args)
    got = tproj.project_gaussians(
        torch.from_numpy(p["means"]), torch.from_numpy(p["quats"]),
        torch.exp(torch.from_numpy(p["scales"])), tcam.viewmat(), tcam.K,
        128, 96, opacities=torch.from_numpy(opac) if with_opac else None,
        **args)
    assert got._fields == ref._fields
    valid = np.asarray(ref.valid)
    assert 100 < valid.sum() < len(valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for name in ref._fields:
        if name == "valid":
            continue
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


def test_min_axis_normal_matches():
    p, _, _ = numpy_scene(500, seed=2)
    ref = jproj.min_axis_normal(jnp.asarray(p["quats"]),
                                jnp.exp(jnp.asarray(p["scales"])))
    got = tproj.min_axis_normal(torch.from_numpy(p["quats"]),
                                torch.exp(torch.from_numpy(p["scales"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches(degree):
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(size=(400, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(400, 3)).astype(np.float32)
    ref = jsh.eval_sh(jnp.asarray(coeffs), jnp.asarray(dirs), degree)
    got = tsh.eval_sh(torch.from_numpy(coeffs), torch.from_numpy(dirs),
                      degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        tsh.degree_mask(16, degree).numpy(),
        np.asarray(jsh.degree_mask(16, jnp.asarray(degree))))


def test_sh0_roundtrip_matches():
    rgb = np.random.default_rng(3).uniform(0, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh0(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh0(jnp.asarray(rgb))),
                               **TOL)
    np.testing.assert_allclose(tsh.sh0_to_rgb(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.sh0_to_rgb(jnp.asarray(rgb))),
                               **TOL)


@pytest.mark.parametrize("sh_degree,step", [(0, 0), (3, 0), (3, 1500),
                                            (3, 5000)])
def test_compute_colors_matches(sh_degree, step):
    p, K, c2w = numpy_scene(600, seed=4, sh_degree=sh_degree)
    jcam, tcam = both_cameras(K, c2w, 128, 96)
    ref = jrade.compute_colors({k: jnp.asarray(v) for k, v in p.items()},
                               jcam, step,
                               jrade.RadeGSConfig(sh_degree=sh_degree))
    got = trade.compute_colors(params_from_numpy(p, device="cpu"), tcam,
                               step, trade.RadeGSConfig(sh_degree=sh_degree))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_params_from_numpy_checks_layout():
    p, _, _ = numpy_scene(10)
    got = params_from_numpy(p, device="cpu")
    assert set(got) == set(p)
    assert all(v.dtype == torch.float32 for v in got.values())
    with pytest.raises(ValueError, match="float32"):
        params_from_numpy({**p, "means": p["means"].astype(np.float64)},
                          device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy({**p, "quats": p["quats"][:, :3]}, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        params_from_numpy({**p, "scales": p["scales"][:5]}, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        params_from_numpy({**p, "colour": p["means"]}, device="cpu")


def test_jax_random_scene_converts():
    """The JAX package's own generator output loads unchanged."""
    from collab_splats_tpu.data.synthetic import random_gaussian_params

    p = random_gaussian_params(jax.random.PRNGKey(0), 32, sh_degree=3,
                               latent_dim=13)
    got = params_from_numpy({k: np.asarray(v) for k, v in p.items()},
                            device="cpu")
    assert got["features_rest"].shape == (32, 15, 3)
    assert got["distill_features"].shape == (32, 13)

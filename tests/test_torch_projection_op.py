"""The fused projection op (``ops/cuda/projection.py``) and its plain
versions: ``core/projection.py::project_backward`` against autograd of
``project_gaussians`` in float64, at every clamp, where and flip of the
forward, for the rows and the camera; the op on the CPU against the plain
forward and autograd, with and without a camera that takes a gradient;
and, on a card, the kernels against the plain versions."""

import math

import numpy as np
import pytest
import torch

from collab_splats_tpu_torch.core import projection as P
from collab_splats_tpu_torch.core.cameras import camera_from_numpy
from collab_splats_tpu_torch.core.options import RenderOptions
from collab_splats_tpu_torch.data.synthetic import look_at_c2w
from collab_splats_tpu_torch.models.gaussians import pad_to_capacity
from collab_splats_tpu_torch.ops import rasterize
from collab_splats_tpu_torch.ops.cuda import projection as op
from collab_splats_tpu_torch.utils import profiling

torch.set_num_threads(2)
W, H = 128, 96
N = 600
DIFF = ("mean2d", "depth", "conic", "plane", "normal", "compensation")


def camera(dtype=torch.float32, device="cpu"):
    c2w = look_at_c2w(np.array([3.0, 0.4, 1.1]), np.zeros(3))
    f = 1.2 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam = camera_from_numpy(K, c2w.astype(np.float32), W, H, device=device)
    return cam.viewmat().to(dtype), cam.K.to(dtype)


def random_rows(rng, n=N):
    q = rng.normal(size=(n, 4))
    return {"means": rng.uniform(-1.2, 1.2, (n, 3)),
            "quats": q,
            "scales": rng.uniform(0.01, 0.08, (n, 3)),
            "opacities": rng.uniform(0.0, 1.0, n)}


def rows_in_camera(rows, viewmat, z):
    """``rows`` with their means moved along the camera's axis to depths
    ``z`` (the same x, y in the camera)."""
    vm = viewmat.double().numpy()
    p = rows["means"] @ vm[:3, :3].T + vm[:3, 3]
    p[:, 2] = z
    rows["means"] = (p - vm[:3, 3]) @ vm[:3, :3]
    return rows


def case_rows(case, viewmat):
    """(rows, eps2d, use opacities) of a named case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    rows = random_rows(rng)
    n = N
    eps2d, with_opac = 0.3, True
    if case == "no_opacities":
        with_opac = False
    elif case == "behind_near_plane":
        # A third behind the camera, a third between it and the near plane.
        z = rng.uniform(1.0, 4.0, n)
        z[: n // 3] = rng.uniform(-2.0, -0.1, n // 3)
        z[n // 3: 2 * n // 3] = rng.uniform(0.0, 0.009, n // 3)
        rows = rows_in_camera(rows, viewmat, z)
    elif case == "facing_flip":
        # In the depth range the raw normal faces away (n_raw . p = z^2);
        # behind the camera, with zs = 1, it takes either side.
        z = rng.uniform(1.0, 4.0, n)
        z[: 2 * n // 3] = rng.uniform(-3.0, -0.1, 2 * n // 3)
        rows = rows_in_camera(rows, viewmat, z)
    elif case == "off_screen":
        vm = viewmat.double().numpy()
        rows["means"][::2] += 6.0 * vm[0, :3]
        rows["means"][1::4] -= 6.0 * vm[1, :3]
    elif case == "needle_compensation_clamp":
        # Two zero scales: a rank-1 2D covariance, det_raw ~ 0.
        rows["scales"][::2, 1:] = 0.0
    elif case == "det_floor":
        # No blur: det = det_raw ~ 0 at the needles and 0 at the points.
        eps2d = 0.0
        rows["scales"][::3, 1:] = 0.0
        rows["scales"][1::3] = 0.0
    elif case == "dead_rows":
        # The trainer's capacity padding: unit quaternions, log-scale -15,
        # means 0, zero opacity.
        pad = {"means": rows["means"], "quats": rows["quats"],
               "scales": np.log(rows["scales"])}
        pad = pad_to_capacity({k: torch.from_numpy(v)
                               for k, v in pad.items()}, 2 * n)
        rows = {"means": pad["means"].numpy(), "quats": pad["quats"].numpy(),
                "scales": np.exp(pad["scales"].numpy()),
                "opacities": np.concatenate([rows["opacities"],
                                             np.zeros(n)])}
    return rows, eps2d, with_opac


CASES = ["random", "no_opacities", "behind_near_plane", "off_screen",
         "needle_compensation_clamp", "det_floor", "facing_flip",
         "dead_rows"]


def _check_case(case, terms, valid, n):
    """The case reaches what it is meant to."""
    frac = {
        "random": valid.float().mean(),
        "no_opacities": valid.float().mean(),
        "behind_near_plane": (~terms.in_depth).float().mean(),
        "off_screen": (~valid).float().mean(),
        "needle_compensation_clamp": (~terms.ratio_pos).float().mean(),
        "det_floor": (~terms.ok_det).float().mean(),
        "facing_flip": terms.flip.float().mean(),
        "dead_rows": (~terms.ratio_pos[n // 2:]).float().mean(),
    }[case]
    assert 0.1 < float(frac) <= 1.0, (case, float(frac))
    if case == "facing_flip":
        assert float(frac) < 0.9


@pytest.mark.parametrize("case", CASES)
def test_project_backward_matches_autograd(case):
    dt = torch.float64
    viewmat, K = camera(dt)
    rows, eps2d, with_opac = case_rows(case, viewmat)
    means, quats, scales = (torch.tensor(rows[k], dtype=dt,
                                         requires_grad=True)
                            for k in ("means", "quats", "scales"))
    viewmat.requires_grad_(True)
    K.requires_grad_(True)
    proj_camera = (viewmat, K)
    opac = torch.tensor(rows["opacities"], dtype=dt) if with_opac else None
    kw = dict(eps2d=eps2d, near_plane=0.01, far_plane=1e10)
    proj = P.project_gaussians(means, quats, scales, viewmat, K, W, H,
                               opacities=opac, **kw)
    n = means.shape[0]
    viewmat, K = viewmat.detach(), K.detach()
    _check_case(case, P._terms(means.detach(), quats.detach(),
                               scales.detach(), viewmat, K, **kw),
                proj.valid, n)
    rng = np.random.default_rng(7)
    outs = [getattr(proj, name) for name in DIFF]
    cots = [torch.tensor(rng.normal(size=o.shape), dtype=dt) for o in outs]
    ref = torch.autograd.grad(outs, [means, quats, scales, *proj_camera],
                              cots)
    got = P.project_backward(means.detach(), quats.detach(), scales.detach(),
                             viewmat, K, *kw.values(), *cots, camera=True)
    rows_only = P.project_backward(means.detach(), quats.detach(),
                                   scales.detach(), viewmat, K, *kw.values(),
                                   *cots)
    assert rows_only[3:] == (None, None)
    for g, r in zip(rows_only[:3], got[:3]):
        assert torch.equal(g, r)
    for name, g, r in zip(("means", "quats", "scales", "viewmat", "K"), got,
                          ref):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-9,
                                   atol=1e-9 * float(r.abs().max()),
                                   err_msg=f"{case}: {name}")


@pytest.mark.parametrize("with_opac", [True, False])
def test_op_forward_on_cpu_is_the_plain_forward(with_opac):
    viewmat, K = camera()
    rows = {k: torch.tensor(v, dtype=torch.float32) for k, v in
            random_rows(np.random.default_rng(3)).items()}
    opac = rows["opacities"] if with_opac else None
    args = (rows["means"], rows["quats"], rows["scales"], viewmat, K, W, H)
    kw = dict(eps2d=0.3, near_plane=0.01, far_plane=1e10, radius_clip=0.0,
              opacities=opac)
    got = op.project(*args, **kw)
    ref = P.project_gaussians(*args, **kw)
    assert got._fields == ref._fields
    for name in ref._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def _grads(fn, rows, viewmat, K, cots, camera=()):
    """Gradients of ``fn``'s six differentiable outputs, in ``cots``'
    directions, with respect to means, quats, scales and the camera's
    ``camera`` ("viewmat", "K")."""
    means, quats, scales = (rows[k].clone().requires_grad_(True)
                            for k in ("means", "quats", "scales"))
    cam = {"viewmat": viewmat.clone().requires_grad_("viewmat" in camera),
           "K": K.clone().requires_grad_("K" in camera)}
    proj = fn(means, quats, scales, cam["viewmat"], cam["K"], W, H,
              opacities=rows["opacities"])
    outs = [getattr(proj, name) for name in DIFF]
    return torch.autograd.grad(outs, [means, quats, scales,
                                      *(cam[c] for c in camera)], cots)


def _cpu_case(seed):
    viewmat, K = camera()
    rows = {k: torch.tensor(v, dtype=torch.float32) for k, v in
            random_rows(np.random.default_rng(seed)).items()}
    ref_proj = P.project_gaussians(rows["means"], rows["quats"],
                                   rows["scales"], viewmat, K, W, H)
    rng = np.random.default_rng(seed + 1)
    cots = [torch.tensor(rng.normal(size=getattr(ref_proj, name).shape),
                         dtype=torch.float32) for name in DIFF]
    return rows, viewmat, K, cots


def test_op_gradients_on_cpu_match_autograd():
    rows, viewmat, K, cots = _cpu_case(4)
    got = _grads(op.project, rows, viewmat, K, cots)
    ref = _grads(P.project_gaussians, rows, viewmat, K, cots)
    for name, g, r in zip(("means", "quats", "scales"), got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(r.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("camera_grads", [("viewmat",), ("K",),
                                          ("viewmat", "K")])
def test_op_camera_gradient_on_cpu_matches_autograd(camera_grads):
    """A camera that requires grad (pose optimisation) goes through the op
    like any other, and its gradient is autograd's of the plain chain."""
    rows, viewmat, K, cots = _cpu_case(6)
    got = _grads(op.project, rows, viewmat, K, cots, camera_grads)
    ref = _grads(P.project_gaussians, rows, viewmat, K, cots, camera_grads)
    names = ("means", "quats", "scales") + camera_grads
    for name, g, r in zip(names, got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(r.abs().max()),
                                   err_msg=name)


def test_fused_rows_counter_reads_zero_off_the_card():
    viewmat, K = camera()
    rows = {k: torch.tensor(v, dtype=torch.float32) for k, v in
            random_rows(np.random.default_rng(8)).items()}
    cam = camera_from_numpy(
        K.numpy(), look_at_c2w(np.array([3.0, 0.4, 1.1]), np.zeros(3)),
        W, H, device="cpu")
    profiling.reset()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rasterize._project(rows["means"], rows["quats"], rows["scales"],
                           rows["opacities"], cam, RenderOptions(), None,
                           None)
    c = profiling.totals()["counters"]
    profiling.reset()
    assert c["render.rows"] == N
    assert c["render.fused_rows"] == 0


def _close(got, ref, rtol):
    """max |got - ref| over max |ref| is at most ``rtol``."""
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)) \
        <= rtol


@pytest.mark.card
def test_kernels_match_the_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    viewmat, K = camera(device=dev)
    rng = np.random.default_rng(9)
    rows = {k: torch.tensor(v, dtype=torch.float32, device=dev)
            for k, v in random_rows(rng, 200_000).items()}
    args = (rows["means"], rows["quats"], rows["scales"], viewmat, K, W, H,
            0.3, 0.01, 1e10, 0.0, rows["opacities"])
    got = op.project_fwd(*args)
    ref = P.project_gaussians(*args[:7], eps2d=0.3, near_plane=0.01,
                              far_plane=1e10, radius_clip=0.0,
                              opacities=rows["opacities"])
    same = (got.valid == ref.valid) & (got.radius == ref.radius) \
        & (got.radius_xy == ref.radius_xy).all(-1)
    assert int((~same).sum()) <= math.ceil(same.numel() / 100_000)
    for name in DIFF:
        g, r = getattr(got, name)[same], getattr(ref, name)[same]
        assert _close(g, r, 1e-5), name
    cots = [torch.tensor(rng.normal(size=getattr(ref, name).shape),
                         dtype=torch.float32, device=dev) for name in DIFF]
    got_g = op.project_bwd(*args[:5], 0.3, 0.01, 1e10, *cots, camera=True)
    ref_g = P.project_backward(*(x.double() for x in args[:5]), 0.3, 0.01,
                               1e10, *(c.double() for c in cots),
                               camera=True)
    for name, g, r in zip(("means", "quats", "scales"), got_g, ref_g):
        assert _close(g[same].double(), r[same], 1e-4), name
    for name, g, r in zip(("viewmat", "K"), got_g[3:], ref_g[3:]):
        assert _close(g.double(), r, 1e-4), name

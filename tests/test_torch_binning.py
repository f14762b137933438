"""Parity of the port's tile binning with both JAX binning paths, on the CPU.

The port's ``bin_gaussians`` is fed the JAX ``Projection`` arrays and held
bit-exact against the JAX XLA path and the Pallas run-length decode
(interpret mode) on the live contract of tests/test_binning_pallas.py:
segment bounds, the in-tile slice of the sorted stream, windows, masks and
spill.  The one allowed difference: the port computes the cull threshold
log(opac / ALPHA_CUTOFF) itself, and XLA's and ATen's float32 ``log`` may
differ by an ulp.  Where that flips a cull decision, exactly those
(gaussian, tile) entries are removed from both streams (and printed with
their min sigma and both thresholds) before the streams are compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.compositing import ALPHA_CUTOFF
from collab_splats_tpu.core.options import RenderOptions as JOpts
from collab_splats_tpu.core.cameras import make_camera
from collab_splats_tpu.core.projection import project_gaussians
from collab_splats_tpu.ops import tiles as jtiles
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.core.projection import Projection
from collab_splats_tpu_torch.ops import tiles as ttiles
from collab_splats_tpu_torch.ops.cuda import binning_kernel, build
from test_torch_core import numpy_scene

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _project(n, seed=0, width=128, height=96):
    """The JAX projection of a numpy scene (opacity-aware radius_xy)."""
    p, K, c2w = numpy_scene(n, seed=seed, width=width, height=height)
    cam = make_camera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height,
                      jnp.asarray(c2w))
    opac = jax.nn.sigmoid(jnp.asarray(p["opacities"][:, 0]))
    proj = project_gaussians(
        jnp.asarray(p["means"]), jnp.asarray(p["quats"]),
        jnp.exp(jnp.asarray(p["scales"])), cam.viewmat(), cam.K, width,
        height, opacities=opac,
    )
    return proj, opac, cam


def _jax_bins(monkeypatch, path, proj, cam, opts, opac):
    monkeypatch.setenv("COLLAB_SPLATS_BINNING", path)
    return jtiles.bin_gaussians(proj, cam.width, cam.height, opts, opac)


def _port_bins(proj, cam, opts, opac):
    tproj = Projection(*(torch.from_numpy(np.array(x)) for x in proj))
    topac = None if opac is None else torch.from_numpy(np.array(opac))
    return ttiles.bin_gaussians(tproj, cam.width, cam.height, opts, topac)


def _stream(bins):
    """Live (tile, gid) entries of the sorted stream, in order."""
    starts = np.asarray(bins.starts)
    tile = np.repeat(np.arange(len(starts) - 1), np.diff(starts))
    return list(zip(tile.tolist(),
                    np.asarray(bins.sorted_gid)[:starts[-1]].tolist()))


def _cull_flips(diff, proj, opac, ntx, ts):
    """Check every differing entry is a cull decision flipped by the two
    thresholds alone; print each."""
    g = np.array([e[1] for e in diff])
    t = np.array([e[0] for e in diff])
    tx = torch.from_numpy((t % ntx * ts).astype(np.float32))
    ty = torch.from_numpy((t // ntx * ts).astype(np.float32))
    mean = torch.from_numpy(np.array(proj.mean2d)[g])
    conic = torch.from_numpy(np.array(proj.conic)[g])
    min_sig = binning_kernel._min_sigma_rect(
        mean[:, 0], mean[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
        tx, tx + ts, ty, ty + ts).numpy()
    o = np.array(opac)
    thr_port = ttiles.cull_threshold(torch.from_numpy(o), len(o),
                                     "cpu").numpy()[g]
    thr_jax = np.asarray(jnp.log(jnp.clip(jnp.asarray(o) / ALPHA_CUTOFF,
                                          1e-12, None)))[g]
    for e, m, a, b in zip(diff, min_sig, thr_port, thr_jax):
        print(f"cull flip (tile, gid)={e}: min_sig={m!r} "
              f"thresh port={a!r} jax={b!r}")
    assert np.all((min_sig <= thr_port) != (min_sig <= thr_jax)), \
        "stream difference not explained by the cull threshold's log"


def assert_port_matches(got, ref, proj, opac, ntx, ts):
    gs, rs = _stream(got), _stream(ref)
    diff = set(gs) ^ set(rs)
    if diff:
        assert opac is not None
        _cull_flips(sorted(diff), proj, opac, ntx, ts)
        assert [e for e in gs if e not in diff] == \
            [e for e in rs if e not in diff]
        return
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(ref.starts))
    live = int(np.asarray(ref.starts)[-1])
    np.testing.assert_array_equal(got.sorted_gid.numpy()[:live],
                                  np.asarray(ref.sorted_gid)[:live])
    mask = np.asarray(ref.tile_mask)
    np.testing.assert_array_equal(got.tile_mask.numpy(), mask)
    np.testing.assert_array_equal(got.tile_gauss.numpy()[mask],
                                  np.asarray(ref.tile_gauss)[mask])
    assert int(got.spilled) == int(ref.spilled)
    assert (got.num_tiles_x, got.num_tiles_y) == (ref.num_tiles_x,
                                                  ref.num_tiles_y)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("n", [257, 3000])
def test_binning_matches_both_jax_paths(monkeypatch, n, cull, exact):
    proj, opac, cam = _project(n)
    kw = dict(max_intersections=1 << 14, tile_capacity=64,
              exact_binning=exact, ellipse_cull=cull)
    jopts = JOpts(pallas_interpret=True, **kw)
    got = _port_bins(proj, cam, TOpts(**kw), opac)
    ntx = got.num_tiles_x
    for path in ("xla", "pallas"):
        ref = _jax_bins(monkeypatch, path, proj, cam, jopts, opac)
        assert_port_matches(got, ref, proj, opac, ntx, 16)


def test_binning_global_overflow(monkeypatch):
    """Whole-gaussian drops (global buffer overflow) stay identical."""
    proj, opac, cam = _project(3000)
    kw = dict(max_intersections=1 << 12, tile_capacity=64)
    got = _port_bins(proj, cam, TOpts(**kw), opac)
    for path in ("xla", "pallas"):
        ref = _jax_bins(monkeypatch, path, proj, cam,
                        JOpts(pallas_interpret=True, **kw), opac)
        assert int(got.spilled) == int(ref.spilled) > 0
        assert_port_matches(got, ref, proj, opac, got.num_tiles_x, 16)


def test_binning_no_opacities(monkeypatch):
    proj, _, cam = _project(257)
    kw = dict(max_intersections=1 << 14, tile_capacity=64)
    got = _port_bins(proj, cam, TOpts(**kw), None)
    ref = _jax_bins(monkeypatch, "xla", proj, cam, JOpts(**kw), None)
    assert_port_matches(got, ref, proj, None, got.num_tiles_x, 16)


def test_binning_odd_size_matches(monkeypatch):
    """A 100x75 image: the tile grid overhangs the image on both axes."""
    proj, opac, cam = _project(257, width=100, height=75)
    kw = dict(max_intersections=1 << 14, tile_capacity=64)
    got = _port_bins(proj, cam, TOpts(**kw), opac)
    assert (got.num_tiles_x, got.num_tiles_y) == (7, 5)
    ref = _jax_bins(monkeypatch, "xla", proj, cam, JOpts(**kw), opac)
    assert_port_matches(got, ref, proj, opac, got.num_tiles_x, 16)


@pytest.mark.parametrize("cull", [True, False])
def test_decode_stream_contract(cull):
    """The decode's whole (key, gid) stream: owned slots carry their tile and
    rank, every other slot the sentinel key and gid 0 -- on the CPU the
    wrapper runs the plain version."""
    proj, opac, cam = _project(257)
    tproj = Projection(*(torch.from_numpy(np.array(x)) for x in proj))
    opts = TOpts(max_intersections=1 << 13, ellipse_cull=cull)
    plan = ttiles.plan_bins(tproj, cam.width, cam.height, opts,
                            torch.from_numpy(np.array(opac)))
    d, m_cap, rank_bits = plan.inputs, plan.m_cap, plan.rank_bits
    num_tiles = plan.ntx * plan.nty
    launches = build.launches["decode_bin_keys"]
    key, gid = binning_kernel.decode_bin_keys(d, m_cap, plan.ntx, 16,
                                              rank_bits, num_tiles)
    # No kernel on the CPU.
    assert build.launches["decode_bin_keys"] == launches
    assert key.shape == gid.shape == (m_cap,)
    assert key.dtype == gid.dtype == torch.int32
    sentinel = num_tiles << rank_bits
    total = int((d.offsets + d.counts)[-1])
    assert 0 < total < m_cap
    dead = key == sentinel
    assert bool(dead[total:].all())
    assert bool((gid[dead] == 0).all())
    live = ~dead
    owner = torch.searchsorted(d.offsets + d.counts, torch.arange(m_cap),
                               right=True)
    assert bool((gid[live] == owner[live]).all())
    assert bool(((key[live] & ((1 << rank_bits) - 1))
                 == d.rank[gid[live].long()]).all())
    assert bool(((key[live] >> rank_bits) < num_tiles).all())
    assert int(dead[:total].sum()) > 0 if cull else int(dead[:total].sum()) == 0

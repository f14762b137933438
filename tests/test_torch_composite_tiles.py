"""Parity of the port's per-tile compositor with the JAX package, on the CPU.

The wrappers (``ops/cuda/composite.py::composite_tiles_fwd`` and
``composite_tiles_bwd_call``, which run their gather plain versions for
CPU tensors: the packed plain versions on the rows gathered through the
aligned ids) are held against the Pallas ``composite_tiles_fwd`` and
``composite_tiles_bwd_call`` in interpret mode, as tests/test_pallas.py
runs them, on the same numpy intersection matrix: six tiles whose segments
are empty, inside one chunk, exactly one chunk, two chunks, and longer than
the ``max_chunks = 2`` the compositor walks; two of them opaque enough to
exit early at ``stop_threshold = 1e-4``.  The port reads that matrix's
columns as rows of a shuffled per-gaussian matrix through distinct ids.
Then ``composite_tiles`` under autograd, with gaussians shared between
slots and a nonzero per-slot sink, is held against JAX's
``pack_intersections`` + sink + ``composite_tiles`` and its gradients with
respect to the per-gaussian rows and the sink.  ``align_segments`` is held
against JAX's on the same ints.

Tolerances: ``nchunks`` and the aligned layout are integers and agree
exactly; maps within rtol = atol = 1e-5 (the JAX kernel sums the in-chunk
transmittance by a triangular matmul, the port slot by slot); gradients
within rtol 5e-4 and atol 5e-5 * max|g| per row group
(tests/test_pallas.py:205-206).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.projection import Projection as JProjection
from collab_splats_tpu.ops import rasterize as jrast
from collab_splats_tpu.ops.pallas import composite as jcomposite
from collab_splats_tpu.ops.tiles import align_segments as jalign
from collab_splats_tpu_torch.ops import tiles
from collab_splats_tpu_torch.ops.cuda import composite

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
NTX, NTY, TS, MAXC = 3, 2, 16, 2
P = TS * TS
NEAR = 0.01
CHUNK = composite.CHUNK
LENS = np.array([0, 90, 128, 200, 256, 300], np.int32)
OPAQUE = (3, 5)   # tiles whose splats are large and nearly opaque
# Row groups of d_isect (ops/cuda/composite.py's row layout).
GROUPS = (("mean", 0, 2), ("conic", 2, 5), ("depth, plane", 5, 8),
          ("opacity", 8, 9), ("normal", 9, 12), ("colour", 12, None))


def intersections(n_color, seed):
    """(isect [D, M], starts [T+1], lens [T]) numpy: random anisotropic
    splats around each tile, front to back, in chunk-aligned segments;
    padding columns hold finite noise, which the compositor must mask."""
    rng = np.random.default_rng(seed)
    t = NTX * NTY
    starts = np.concatenate([[0], np.cumsum(-(-LENS // CHUNK) * CHUNK)])
    m = int(starts[-1]) + CHUNK
    d = 12 + n_color
    d += (-d) % 8
    isect = rng.uniform(-1.0, 1.0, (d, m))
    for tile in range(t):
        n = int(LENS[tile])
        cols = slice(int(starts[tile]), int(starts[tile]) + n)
        u0, v0 = tile % NTX * TS, tile // NTX * TS
        big = tile in OPAQUE
        sx, sy = (rng.uniform(*((6.0, 14.0) if big else (1.0, 9.0)), (2, n)))
        rho = rng.uniform(-0.8, 0.8, n)
        ca, cb, cc = sx * sx + 0.3, rho * sx * sy, sy * sy + 0.3
        det = ca * cc - cb * cb
        isect[:9, cols] = np.stack([
            u0 + rng.uniform(-10, 26, n), v0 + rng.uniform(-10, 26, n),
            cc / det, -cb / det, ca / det,
            np.sort(rng.uniform(0.5, 6.0, n)),
            rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n),
            rng.uniform(*((0.6, 0.999) if big else (0.02, 0.999)), n)])
    return (isect.astype(np.float32), starts.astype(np.int32), LENS.copy())


def as_rows(isect, seed=11):
    """(per_gauss [N, D], ids [M]) numpy with per_gauss[ids[s]] equal to
    column s of ``isect``: distinct ids into a shuffled matrix with 7 more
    rows of noise."""
    rng = np.random.default_rng(seed)
    d, m = isect.shape
    ids = rng.permutation(m + 7)[:m].astype(np.int32)
    per_gauss = rng.uniform(-1.0, 1.0, (m + 7, d)).astype(np.float32)
    per_gauss[ids] = isect.T
    return per_gauss, ids


def slot_valid(starts, lens, m):
    """[M] bool: the slots below each segment's length."""
    valid = np.zeros(m, bool)
    for t, n in enumerate(lens):
        valid[starts[t]:starts[t] + n] = True
    return valid


def jax_fwd(isect, starts, lens, n_color, stop):
    out, nch = jcomposite.composite_tiles_fwd(
        jnp.asarray(isect), jnp.asarray(starts), jnp.asarray(lens), NTX, TS,
        n_color, near_plane=NEAR, stop_threshold=stop, max_chunks=MAXC,
        interpret=True)
    return np.asarray(out), np.array(nch)


def port_fwd(isect, starts, lens, n_color, stop):
    per_gauss, ids = as_rows(isect)
    out, nch = composite.composite_tiles_fwd(
        torch.from_numpy(per_gauss), torch.from_numpy(ids),
        torch.from_numpy(starts), torch.from_numpy(lens), NTX, TS, n_color,
        NEAR, stop, MAXC)
    return out.numpy(), nch.numpy()


@pytest.fixture(scope="module", params=[(3, 0.0), (3, 1e-4), (16, 0.0),
                                        (16, 1e-4)],
                ids=["C3-stop0", "C3-stop1e-4", "C16-stop0", "C16-stop1e-4"])
def forward(request):
    n_color, stop = request.param
    inputs = intersections(n_color, seed=n_color)
    return (n_color, stop, inputs, jax_fwd(*inputs, n_color, stop),
            port_fwd(*inputs, n_color, stop))


def test_align_segments_matches():
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 300, 12)
    lens[[0, 5]] = 0
    m = int(lens.sum()) + 57   # sentinel slots past the last segment
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    gid = rng.integers(0, 1000, m).astype(np.int32)
    ref = jalign(jnp.asarray(bounds), jnp.asarray(gid), CHUNK)
    got = tiles.align_segments(torch.from_numpy(bounds),
                               torch.from_numpy(gid), CHUNK)
    for name, a, b in zip(("aligned_gid", "aligned_starts", "lens"), got,
                          ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    starts, valid = got[1].numpy(), got[3].numpy()
    assert (starts % CHUNK == 0).all()
    assert valid.sum() == lens.sum()
    assert valid.shape == (m + 12 * CHUNK,)


def test_forward_matches_jax(forward):
    n_color, stop, (_, _, lens), (ref, ref_n), (got, got_n) = forward
    assert (lens > CHUNK).any() and (lens > MAXC * CHUNK).any()
    np.testing.assert_array_equal(got_n, ref_n)
    assert got.shape == ref.shape == (NTX * NTY, P, n_color + 6)
    np.testing.assert_allclose(got, ref, **TOL)
    full = np.minimum(-(-lens // CHUNK), MAXC)
    early = got_n < full
    if stop > 0:
        assert early.any(), got_n
        assert (got_n[list(OPAQUE)] < full[list(OPAQUE)]).all()
    else:
        assert not early.any()
    # Every pixel of an opaque tile ends close to alpha 1.
    alpha = got[..., n_color + 3]
    assert alpha[list(OPAQUE)].min() > 0.99


@pytest.fixture(scope="module")
def backward(forward):
    n_color, stop, inputs, (_, nch), _ = forward
    isect, starts, lens = inputs
    g = np.random.default_rng(7).normal(
        size=(NTX * NTY, P, n_color + 6)).astype(np.float32)
    ref = jcomposite.composite_tiles_bwd_call(
        jnp.asarray(isect), jnp.asarray(starts), jnp.asarray(lens), NTX,
        jnp.asarray(nch), jnp.asarray(g), TS, n_color, NEAR, MAXC,
        interpret=True)
    per_gauss, ids = as_rows(isect)
    got = composite.composite_tiles_bwd_call(
        torch.from_numpy(per_gauss), torch.from_numpy(ids),
        torch.from_numpy(starts), torch.from_numpy(lens), NTX,
        torch.from_numpy(nch), torch.from_numpy(g), TS, n_color, NEAR, MAXC)
    # The port's rows are slot-major: one [D] row per slot.
    return n_color, stop, inputs, nch, np.asarray(ref), got.numpy().T


def test_backward_matches_jax(backward):
    n_color, _, (isect, starts, lens), nch, ref, got = backward
    rows = 12 + n_color
    assert got.shape == isect.shape
    for name, a, b in GROUPS:
        b = rows if b is None else b
        ref_g = ref[a:b]
        assert np.abs(ref_g).max() > 0, name
        np.testing.assert_allclose(got[a:b], ref_g, rtol=5e-4,
                                   atol=5e-5 * np.abs(ref_g).max(),
                                   err_msg=name)
    # Nothing outside the processed chunks, nor in the padding rows.
    done = np.zeros(isect.shape[1], bool)
    for t, n in enumerate(nch):
        done[starts[t]:starts[t] + n * CHUNK] = True
    assert not got[:, ~done].any()
    assert not got[rows:].any()


def test_autograd_pairs_the_two(backward):
    """composite_tiles under autograd gives the wrapper's forward maps, the
    backward's slot rows summed per gaussian and the sink's columns for
    the cotangent of a linear loss."""
    n_color, stop, (isect, starts, lens), nch, _, _ = backward
    per_gauss, ids = (torch.from_numpy(x) for x in as_rows(isect))
    valid = torch.from_numpy(slot_valid(starts, lens, ids.shape[0]))
    x = per_gauss.clone().requires_grad_(True)
    sink = torch.zeros((2, ids.shape[0]), requires_grad=True)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(NTX * NTY, P, n_color + 6)).astype(np.float32))
    args = (torch.from_numpy(starts), torch.from_numpy(lens), NTX)
    out = composite.composite_tiles(x, ids, valid, *args, TS, n_color, NEAR,
                                    stop, MAXC, sink=sink)
    assert torch.equal(out.detach(), composite.composite_tiles_fwd(
        per_gauss, ids, *args, TS, n_color, NEAR, stop, MAXC,
        sink=sink.detach())[0])
    d, d_sink = torch.autograd.grad((out * g).sum(), [x, sink])
    d_slot = composite.composite_tiles_bwd_call(
        per_gauss, ids, *args, torch.from_numpy(nch), g, TS, n_color, NEAR,
        MAXC, sink=sink.detach())
    ref = torch.zeros_like(per_gauss)
    ref[ids.long()] = d_slot   # distinct ids: one slot per row
    assert torch.equal(d, ref)
    assert torch.equal(d_sink, d_slot[:, :2].T)


def test_wrappers_refuse_other_devices():
    isect, starts, lens = intersections(3, seed=0)
    per_gauss, ids = (torch.from_numpy(x) for x in as_rows(isect))
    args = (ids.to("meta"), torch.from_numpy(starts),
            torch.from_numpy(lens), NTX)
    with pytest.raises(ValueError, match="unsupported device"):
        composite.composite_tiles_fwd(per_gauss.to("meta"), *args, TS, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        composite.composite_tiles_bwd_call(
            per_gauss.to("meta"), *args, torch.zeros(6, dtype=torch.int32),
            torch.zeros((6, P, 9)), TS, 3, NEAR, MAXC)


def test_backward_clamps_nchunks_to_the_walk():
    """A chunk count past a segment's walk (its length in chunks, at most
    max_chunks) is clamped to it, as the kernel clamps it."""
    isect, starts, lens = intersections(3, seed=0)
    per_gauss, ids = as_rows(isect)
    starts, lens = torch.from_numpy(starts), torch.from_numpy(lens)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(NTX * NTY, P, 9)).astype(np.float32))
    walk = torch.clamp((lens + CHUNK - 1) // CHUNK, max=MAXC)
    args = (torch.from_numpy(per_gauss), torch.from_numpy(ids), starts, lens,
            NTX)
    ref = composite.composite_tiles_bwd_call(*args, walk, g, TS, 3, NEAR,
                                             MAXC)
    got = composite.composite_tiles_bwd_call(*args, walk + 5, g, TS, 3, NEAR,
                                             MAXC)
    assert torch.equal(got, ref)


# ------------------------------------- the gather contract against JAX's pack
def shared_rows(n_color, seed):
    """(per_gauss [N, 12 + C], ids [M], valid [M], starts, lens, sink [2, M])
    numpy: the segments of :func:`intersections`, their slots' gaussians
    one row each, then a third of the slots re-pointed at another slot's
    gaussian, so gaussians are shared between slots and tiles; the sink
    is nonzero."""
    isect, starts, lens = intersections(n_color, seed)
    rng = np.random.default_rng(seed + 100)
    m = isect.shape[1]
    valid = slot_valid(starts, lens, m)
    cols = np.flatnonzero(valid)
    per_gauss = isect[:12 + n_color, cols].T.copy()
    ids = np.zeros(m, np.int32)
    ids[cols] = np.arange(len(cols))
    moved = cols[rng.uniform(size=len(cols)) < 1 / 3]
    ids[moved] = rng.integers(0, len(cols), len(moved))
    sink = rng.normal(0.0, 0.3, (2, m)).astype(np.float32)
    return per_gauss, ids, valid, starts, lens, sink


def jax_gather(n_color, stop, per_gauss, ids, starts, lens, sink, g):
    """JAX's maps, nchunks and the gradients of sum(maps * g) with respect
    to the per-gaussian rows and the sink: ``pack_intersections``, the
    sink added to the packed (u, v) rows as ``render_tiled_pallas`` adds
    it, then ``composite_tiles`` in interpret mode."""
    n = per_gauss.shape[0]

    def pack(pg, sk):
        proj = JProjection(
            mean2d=pg[:, 0:2], depth=pg[:, 5], conic=pg[:, 2:5],
            radius=jnp.zeros(n), compensation=jnp.ones(n),
            plane=pg[:, 6:8], normal=pg[:, 9:12],
            valid=jnp.ones(n, bool), radius_xy=jnp.zeros((n, 2)))
        isect = jrast.pack_intersections(proj, pg[:, 8], pg[:, 12:],
                                         pg[:, 9:12], jnp.asarray(ids))
        return isect.at[0:2, :].add(sk)

    def loss(pg, sk):
        out = jcomposite.composite_tiles(
            pack(pg, sk), jnp.asarray(starts), jnp.asarray(lens), NTX, TS,
            n_color, NEAR, stop, MAXC, True)
        return jnp.sum(out * g)

    pg, sk = jnp.asarray(per_gauss), jnp.asarray(sink)
    out, nch = jcomposite.composite_tiles_fwd(
        pack(pg, sk), jnp.asarray(starts), jnp.asarray(lens), NTX, TS,
        n_color, near_plane=NEAR, stop_threshold=stop, max_chunks=MAXC,
        interpret=True)
    d_pg, d_sink = jax.grad(loss, argnums=(0, 1))(pg, sk)
    return (np.asarray(out), np.asarray(nch), np.asarray(d_pg),
            np.asarray(d_sink))


@pytest.mark.parametrize("n_color,stop", [(3, 0.0), (3, 1e-4), (16, 0.0),
                                          (16, 1e-4)],
                         ids=["C3-stop0", "C3-stop1e-4", "C16-stop0",
                              "C16-stop1e-4"])
def test_gather_contract_matches_jax_pack(n_color, stop):
    per_gauss, ids, valid, starts, lens, sink = shared_rows(n_color, 5)
    g = np.random.default_rng(9).normal(
        size=(NTX * NTY, P, n_color + 6)).astype(np.float32)
    ref, ref_n, ref_pg, ref_sink = jax_gather(n_color, stop, per_gauss, ids,
                                              starts, lens, sink, g)
    assert np.bincount(ids[valid]).max() > 1   # shared gaussians
    dp = composite.row_width(n_color)
    pg = torch.from_numpy(np.pad(per_gauss, ((0, 0),
                                             (0, dp - per_gauss.shape[1]))))
    pg.requires_grad_(True)
    sk = torch.from_numpy(sink).requires_grad_(True)
    tids, tstarts, tlens = (torch.from_numpy(x) for x in (ids, starts, lens))
    out, nch = composite.composite_tiles_fwd(
        pg.detach(), tids, tstarts, tlens, NTX, TS, n_color, NEAR, stop,
        MAXC, sink=sk.detach())
    np.testing.assert_array_equal(nch.numpy(), ref_n)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    maps = composite.composite_tiles(pg, tids, torch.from_numpy(valid),
                                     tstarts, tlens, NTX, TS, n_color, NEAR,
                                     stop, MAXC, sink=sk)
    assert torch.equal(maps.detach(), out)
    d_pg, d_sink = torch.autograd.grad((maps * torch.from_numpy(g)).sum(),
                                       [pg, sk])
    assert not d_pg[:, 12 + n_color:].any()
    for name, a, b in GROUPS:
        b = 12 + n_color if b is None else b
        ref_g = ref_pg[:, a:b]
        assert np.abs(ref_g).max() > 0, name
        np.testing.assert_allclose(d_pg[:, a:b].numpy(), ref_g, rtol=5e-4,
                                   atol=5e-5 * np.abs(ref_g).max(),
                                   err_msg=name)
    np.testing.assert_allclose(d_sink.numpy(), ref_sink, rtol=5e-4,
                               atol=5e-5 * np.abs(ref_sink).max())
    assert not d_sink[:, ~torch.from_numpy(valid)].any()

"""The port's segmentation and grouping against the JAX package's, on the
CPU.

The mask utilities, the classical segmenter and the grouping bookkeeping
are numpy in both packages: their outputs must be equal.
``aggregate_masked_features`` (torch here, with JAX's linear and nearest
resizes) within rtol 3e-4 / atol 3e-5.  ``GroupingClassifier`` runs over
two views of the flagship scene (20,000 Gaussians at 512x512, projected
by the port's render layer); both packages get those projections and the
same composite masks, and must agree on every matched mask, memory-bank set,
vote and label.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from collab_splats_tpu.features import grouping as jgroup
from collab_splats_tpu.features import segmentation as jseg
from collab_splats_tpu_torch.core.options import RenderOptions
from collab_splats_tpu_torch.core.projection import project_gaussians
from collab_splats_tpu_torch.data import synthetic
from collab_splats_tpu_torch.features import grouping as tgroup
from collab_splats_tpu_torch.features import segmentation as tseg
from collab_splats_tpu_torch.models import gaussians
from collab_splats_tpu_torch.ops.rasterize import RenderMeta

torch.set_num_threads(2)
TOL = dict(rtol=3e-4, atol=3e-5)


def random_masks(n, h, w, seed=0):
    """n blob masks (discs of random centre and radius) [n, h, w] bool."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[:h, :w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(3, max(h, w) / 2)
        out.append((ys - cy) ** 2 + (xs - cx) ** 2 < r * r)
    return np.stack(out)


def sam_results(masks, seed=1):
    ious = np.random.default_rng(seed).uniform(0.7, 1.0, len(masks))
    return [{"segmentation": m, "predicted_iou": float(i)}
            for m, i in zip(masks, ious)]


@pytest.mark.parametrize("hw,patches", [((64, 48), 8), ((37, 53), 32)])
def test_patch_mask_matches_jax(hw, patches):
    img = np.zeros(hw + (3,))
    np.testing.assert_array_equal(tseg.create_patch_mask(img, patches),
                                  jseg.create_patch_mask(img, patches))


@pytest.mark.parametrize("n", [1, 12, 300], ids=["one", "some", "over-255"])
def test_composite_and_id_masks_match_jax(n):
    results = sam_results(random_masks(n, 40, 56, seed=n))
    for thresh in (0.85, 0.0):
        ref = jseg.create_composite_mask(results, thresh)
        got = tseg.create_composite_mask(results, thresh)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tseg.mask_id_to_binary_mask(got),
                                      jseg.mask_id_to_binary_mask(ref))
    k = int(got.max())
    labels = np.random.default_rng(2).integers(0, 200, k)
    np.testing.assert_array_equal(tseg.convert_matched_mask(labels, got),
                                  jseg.convert_matched_mask(labels, ref))


@pytest.mark.parametrize("res,final", [((16, 24), (8, 12)),
                                       ((40, 56), (20, 28)),
                                       ((13, 11), (29, 31))])
def test_aggregate_masked_features_matches_jax(res, final):
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(6, 20, 28)).astype(np.float32)
    masks = random_masks(5, 40, 56, seed=4).astype(np.float32)
    ref = np.asarray(jseg.aggregate_masked_features(
        jnp.asarray(feats), jnp.asarray(masks), res, final))
    got = tseg.aggregate_masked_features(torch.from_numpy(feats),
                                         torch.from_numpy(masks), res,
                                         final).numpy()
    assert got.shape == ref.shape == (6,) + final
    np.testing.assert_allclose(got, ref, **TOL)


def test_classical_segmenter_and_facade_match_jax():
    img = np.random.default_rng(5).uniform(0, 1, (48, 64, 3)).astype(
        np.float32)
    img[:, :30] = [0.9, 0.1, 0.1]
    img[20:, 40:] = [0.1, 0.1, 0.9]
    ref = jseg.FelzenszwalbLiteSegmenter()(img)
    got = tseg.FelzenszwalbLiteSegmenter()(img)
    assert len(got) == len(ref) >= 2
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a.pop("segmentation"),
                                      b.pop("segmentation"))
        assert a == b
    # Without converted weights both facades pick the classical segmenter.
    s = tseg.Segmentation(device="cpu")
    assert isinstance(s.backend, tseg.FelzenszwalbLiteSegmenter)
    np.testing.assert_array_equal(s.composite(img),
                                  jseg.Segmentation().composite(img))


def test_object_segment_image_prompts_sam_with_the_boxes():
    calls = []

    class Sam:
        def segment_boxes(self, image, boxes, confs):
            calls.append(("boxes", len(boxes)))
            return []

        def auto_segment(self, image):
            calls.append(("auto", 0))
            return []

    def detector(found):
        return lambda image: (np.zeros((found, 4), np.float32),
                              np.ones(found, np.float32))

    img = np.zeros((8, 8, 3))
    tseg.object_segment_image(Sam(), detector(3))(img)
    tseg.object_segment_image(Sam(), detector(0))(img)
    assert calls == [("boxes", 3), ("auto", 0)]


@pytest.fixture(scope="module")
def flagship_views():
    """The flagship scene (20,000 Gaussians, 512x512) from two orbit
    cameras: (image, meta, composite mask) per view, the meta holding the
    render's projection layer (``project_gaussians`` with its options, the
    opacities activated); the masks split the pixels near a projected
    centre into quadrants and a band."""
    gen = torch.Generator().manual_seed(0)
    params = synthetic.random_gaussian_params(gen, 20_000, extent=1.0,
                                              device="cpu")
    cams = synthetic.orbit_cameras(2, radius=3.0, width=512, height=512,
                                   focal=1.2 * 512, device="cpu")
    opts = RenderOptions(rasterize_mode="antialiased")
    alive = torch.ones(20_000, dtype=torch.bool)
    views = []
    for cam in cams:
        proj = project_gaussians(
            params["means"], params["quats"],
            gaussians.activated_scales(params), cam.viewmat(), cam.K, 512,
            512, eps2d=opts.eps2d, near_plane=opts.near_plane,
            opacities=gaussians.activated_opacity(params, alive))
        meta = RenderMeta(proj, None, 512, 512)
        xy = proj.mean2d[proj.valid].round().long().clamp(0, 511).numpy()
        a = np.zeros((512, 512), bool)
        a[xy[:, 1], xy[:, 0]] = True
        a = ndimage.binary_dilation(a, iterations=3)
        comp = np.zeros((512, 512), np.uint8)
        comp[:256, :256][a[:256, :256]] = 1
        comp[:256, 256:][a[:256, 256:]] = 2
        comp[256:, :256][a[256:, :256]] = 3
        comp[256:, 256:][a[256:, 256:]] = 4
        comp[240:272][a[240:272]] = 5
        views.append((np.zeros((512, 512, 3), np.float32), meta, comp))
    return views


def as_jax_meta(meta):
    """The port's projections as the numpy arrays JAX's
    ``project_gaussians`` reads."""
    return SimpleNamespace(
        width=meta.width, height=meta.height, proj=SimpleNamespace(
            radius=meta.proj.radius.numpy(), mean2d=meta.proj.mean2d.numpy(),
            depth=meta.proj.depth.numpy()))


def test_grouping_matches_jax_on_flagship_views(flagship_views):
    params = dict(min_gaussians_per_mask=3, iou_threshold=0.2)
    ref = jgroup.GroupingClassifier(
        20_000, jgroup.GroupingParams(**params),
        segmentation=jseg.Segmentation(backend=lambda image: []))
    got = tgroup.GroupingClassifier(
        20_000, tgroup.GroupingParams(**params),
        segmentation=tseg.Segmentation(backend=lambda image: []))
    for img, meta, comp in flagship_views:
        np.testing.assert_array_equal(
            got.associate(img, meta, composite_mask=comp),
            ref.associate(img, as_jax_meta(meta), composite_mask=comp))
    assert got.num_objects == ref.num_objects >= 5
    for a, b in zip(got.bank, ref.bank):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.votes, ref.votes)
    for min_votes in (1, 2):
        np.testing.assert_array_equal(got.gaussian_labels(min_votes),
                                      ref.gaussian_labels(min_votes))
    assert (got.gaussian_labels() >= 0).sum() > 100


def test_grouping_caps_objects_like_jax(flagship_views):
    img, meta, comp = flagship_views[0]
    params = dict(min_gaussians_per_mask=1, max_objects=2,
                  iou_threshold=1.0)
    ref = jgroup.GroupingClassifier(
        20_000, jgroup.GroupingParams(**params),
        segmentation=jseg.Segmentation(backend=lambda image: []))
    got = tgroup.GroupingClassifier(
        20_000, tgroup.GroupingParams(**params),
        segmentation=tseg.Segmentation(backend=lambda image: []))
    np.testing.assert_array_equal(
        got.associate(img, meta, composite_mask=comp),
        ref.associate(img, as_jax_meta(meta), composite_mask=comp))
    assert got.num_objects == ref.num_objects == 2
    np.testing.assert_array_equal(got.votes, ref.votes)

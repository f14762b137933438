"""The feature towers at their published widths in the port against the
plain reference ``tests/plain_vit.py``, on the CPU, on seeded random
weights.

* MaskCLIP's visual tower at CLIP ViT-L/14's width (1024, 16 heads of 64,
  MLP 4096) over two blocks, one ordinary and the MaskCLIP one, on a
  98x70 input; DINOv2 ViT-S/14 whole (384 wide, 6 heads, 12 blocks) with
  LayerScale as the benchmark draws it, on a 126x84 input.
* ``FeatureDatamanager.extract`` on a 1280x720 frame through converted
  ``.npz`` files found by ``COLLAB_SPLATS_WEIGHTS``, at a narrow width:
  the maps against the reference's, their shapes, ``_setup_features``
  giving the same maps, and the spans and the ``vit.tokens`` counter of
  one ``extract`` under a recording session.

Tolerances: the port and the reference compute the same float32 sums in
another order (all heads at once against one head at a time, the
positions through ``F.interpolate`` against explicit matrices), which
leaves under 1e-6 of the largest value on a tower.  Through the
datamanager the resizes add more: the port's resampling matrices and
``F.interpolate`` both take the sample positions in float32, which at a
1280-pixel edge moves a weight by up to 3e-5, so the prepared images
differ by about 3e-5 of their largest value.  Each limit below is a few
times its reading; the reference in emulated TF32
(``Precision(tf32=True)``) exceeds each by more than ten times
(asserted), and each of the benchmark's faults the tower's by more than
a hundred times.
"""

import numpy as np
import pytest
import torch

import plain_vit as R
from collab_splats_tpu_torch.data.datamanager import FullImageDatamanager
from collab_splats_tpu_torch.features import datamanager as DM
from collab_splats_tpu_torch.features import extractors as EX
from collab_splats_tpu_torch.features import vit
from collab_splats_tpu_torch.utils import profiling

torch.set_num_threads(2)

CLIP = R.ClipSpec(layers=2, text_width=64, text_layers=1, vocab=600)
DINO = R.DinoSpec()
# Largest |port - reference| over the largest |reference|: readings
# 4.6e-7 (MaskCLIP, 1024 wide) and 5.6e-7 (DINOv2, 12 blocks), and through
# the datamanager at width 64 4.8e-6 (CLIP) and 3.3e-6 (DINOv2); the
# reference in emulated TF32 reads 5.7e-4, 5.0e-4, 5.3e-4 and 8.9e-4.
TOWER_TOL = 3e-6
MAP_TOL = 2e-5


def gap(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def image(h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((h, w, 3), generator=g)


@pytest.fixture(scope="module")
def clip():
    p = R.init_clip(CLIP, torch.Generator().manual_seed(0), "cpu")
    img = image(98, 70, 1)
    return p, img, R.maskclip_forward(p, img, 7, 5, 16, 14, R.Precision())


@pytest.fixture(scope="module")
def dino():
    p = R.init_dinov2(DINO, torch.Generator().manual_seed(2), "cpu")
    img = image(126, 84, 3)
    return p, img, R.dinov2_forward(p, img, 9, 6, 6, 14, R.Precision())


def test_maskclip_at_the_published_width_matches_the_reference(clip):
    p, img, ref = clip
    got = vit.maskclip_forward(p, img, 16, 14)
    assert got.shape == ref.shape == (35, 768)
    assert gap(got, ref) <= TOWER_TOL
    tf32 = R.maskclip_forward(p, img, 7, 5, 16, 14, R.Precision(tf32=True))
    assert gap(tf32, ref) > 10 * TOWER_TOL


def test_dinov2_at_the_published_width_matches_the_reference(dino):
    p, img, ref = dino
    assert int(p["n_blocks"]) == 12
    got = vit.dinov2_forward(p, img, 6, 14)
    assert got.shape == ref.shape == (54, 384)
    assert gap(got, ref) <= TOWER_TOL
    tf32 = R.dinov2_forward(p, img, 9, 6, 6, 14, R.Precision(tf32=True))
    assert gap(tf32, ref) > 10 * TOWER_TOL


@pytest.mark.parametrize("fault", ["attention_head", "bilinear_positions",
                                   "no_layer_scale"])
def test_each_fault_is_another_tower(clip, dino, fault):
    if fault == "no_layer_scale":
        p, img, ref = dino
        got = R.dinov2_forward(p, img, 9, 6, 6, 14, R.Precision(),
                               layer_scale=False)
    else:
        p, img, ref = clip
        got = R.maskclip_forward(
            p, img, 7, 5, 16, 14, R.Precision(),
            maskclip_head=fault != "attention_head",
            pos_kind="bilinear" if fault == "bilinear_positions"
            else "bicubic")
    assert gap(got, ref) > 100 * TOWER_TOL


def test_position_matrices_match_interpolate():
    """The reference's explicit bicubic matrix is ``F.interpolate``'s
    bicubic (half-pixel centres, clamped taps) at the grids of the cell.
    Reading 2.1e-6: ``F.interpolate`` takes the source position in
    float32 (the scale 24 / 41 rounded), the matrix in float64."""
    table = torch.randn((1 + 24 * 24, 8), generator=torch.Generator(
    ).manual_seed(4))
    for rows, cols in ((41, 73), (7, 5)):
        got = R.positions(table, rows, cols)
        want = vit.interpolate_pos_embed(table, (rows, cols))
        assert gap(got, want) <= 1e-5


# ------------------------------------------------ through the datamanager
NARROW_CLIP = R.ClipSpec(width=64, layers=2, heads=1, embed=48,
                         text_width=64, text_layers=1, vocab=600)
NARROW_DINO = R.DinoSpec(width=64, layers=2, heads=1)
TOWERS = {"clip": R.Tower(1024, 14, 1, (0.485, 0.456, 0.406),
                          (0.229, 0.224, 0.225)),
          "dinov2": R.Tower(800, 14, 1, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))}


def frames(n, seed=5):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand((720, 1280, 3), generator=g) * 255).to(torch.uint8)
            .numpy() for _ in range(n)]


@pytest.fixture
def narrow_dm(tmp_path, monkeypatch):
    """(the datamanager on two frames, its frames, the weights) with both
    towers read from ``.npz`` files through ``COLLAB_SPLATS_WEIGHTS``."""
    weights = {
        "clip": R.init_clip(NARROW_CLIP, torch.Generator().manual_seed(6),
                            "cpu"),
        "dinov2": R.init_dinov2(NARROW_DINO,
                                torch.Generator().manual_seed(7), "cpu")}
    for name, p in (("clip_vitl14_336.npz", weights["clip"]),
                    ("dinov2_vits14.npz", weights["dinov2"])):
        np.savez(tmp_path / name, **{k: v.numpy() for k, v in p.items()})
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(tmp_path))
    EX._default_extractor.cache_clear()
    fs = frames(2)
    base = FullImageDatamanager([None] * 2, [], fs, [])
    dm = DM.FeatureDatamanager(base, DM.FeatureDatamanagerConfig(),
                               device="cpu")
    yield dm, fs, weights
    EX._default_extractor.cache_clear()


def test_extract_matches_the_reference_at_the_cells_shapes(narrow_dm):
    dm, fs, weights = narrow_dm
    clip_ex, dino_ex = dm._extractors["clip-vit"], dm._extractors["dinov2"]
    assert clip_ex.pretrained and dino_ex.pretrained
    assert (clip_ex.feature_dim, dino_ex.feature_dim) == (48, 64)
    got = dm.extract(fs[0])
    assert set(got) == {"clip-vit", "dinov2"}
    # CLIP: 1022x574, a 73x41 grid brought down to 64x35; DINOv2:
    # 798x448, a 57x32 grid, kept.
    assert tuple(got["clip-vit"].shape) == (48, 35, 64)
    assert tuple(got["dinov2"].shape) == (64, 32, 57)
    frame = torch.from_numpy(fs[0])
    for kind, name in (("clip", "clip-vit"), ("dinov2", "dinov2")):
        ref = R.tower_map(kind, weights[kind], frame, TOWERS[kind], 64,
                          R.Precision())
        assert gap(got[name], ref) <= MAP_TOL
        tf32 = R.tower_map(kind, weights[kind], frame, TOWERS[kind], 64,
                           R.Precision(tf32=True))
        assert gap(tf32, ref) > 10 * MAP_TOL


def test_setup_features_keeps_what_extract_gives(narrow_dm):
    dm, fs, _ = narrow_dm
    for i, frame in enumerate(fs):
        again = dm.extract(frame)
        for name, m in dm.train_features[i].items():
            assert torch.equal(m, again[name])
    assert dm.feature_dims == {"clip-vit": (48, 35, 64),
                               "dinov2": (64, 32, 57)}


def test_extract_records_its_spans_and_tokens(narrow_dm):
    from torch.profiler import ProfilerActivity, profile

    dm, fs, _ = narrow_dm
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        dm.extract(fs[1])
    t = profiling.totals()
    spans = t["spans"]
    assert spans["features.image"]["count"] == 1
    assert spans["features.clip"]["parents"] == ["features.image"]
    assert spans["features.dinov2"]["parents"] == ["features.image"]
    # CLIP's first block (the second is MaskCLIP's value path) and
    # DINOv2's two.
    assert spans["vit.attention"]["count"] == 3
    assert sorted(spans["vit.attention"]["parents"]) == \
        ["features.clip", "features.dinov2"]
    assert t["counters"]["vit.tokens"] == (73 * 41 + 1) + (57 * 32 + 1)
    profiling.reset()
    dm.extract(fs[1])
    assert profiling.totals() == {"spans": {}, "counters": {}}

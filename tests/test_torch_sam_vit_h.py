"""SAM's automatic mask generation in the port against the plain reference
``tests/plain_sam.py``, on the CPU, on seeded random weights.

* The image encoder at the full 1024 input (the port's encoder is fixed at
  64x64 tokens) at a narrow width: 64 wide, 4 heads, 4 blocks with the last
  global, window 14.
* The mask decoder at its published widths (256, depth 2, 8 heads, MLP
  2048) for a batch of 4 point prompts, multimask on and off, with SAM's
  two-way transformer LayerNorm eps (1e-5), which a backend that names its
  model runs; without a name it runs the JAX package's 1e-6.
* The automatic masks' device filter (``sam_predictor.filter_masks``)
  against the host loop it replaced, on identical logits with ties and
  with thresholds set to values the data holds: the kept lists are equal.
* The model choice: ViT-H's table, a ViT-B file refused, ViT-H's parameter
  count on the ``meta`` device.
* The spans and counters of one ``auto_segment`` under a recording
  session.

Tolerances: the port and the reference compute the same float32 sums in
another order (all heads at once against one head at a time, the 6-D
relative-position sum against two broadcasts), which leaves about 1e-6 of
the largest value; the limits below are a few times the readings and a
reference run in emulated TF32 (``Precision(tf32=True)``) exceeds each by
more than ten times (asserted).
"""

import dataclasses

import numpy as np
import pytest
import torch

import plain_sam as R
from collab_splats_tpu_torch.features import sam as S
from collab_splats_tpu_torch.features import sam_predictor as SP
from collab_splats_tpu_torch.utils import profiling

torch.set_num_threads(2)

NARROW = R.Spec(dim=64, depth=4, heads=4, global_blocks=(3,))
# Largest |port - reference| over the largest |reference| (the IoU: the
# largest |port - reference|): readings 2.9e-7 (encoder), 1.2e-6 (logits)
# and 6.0e-8 (IoU); the reference in emulated TF32 reads 2.3e-3, 1.7e-3 and
# 8.1e-6.
ENC_TOL = 3e-6
LOGIT_TOL = 1e-5
IOU_TOL = 5e-7


def params(spec=NARROW, seed=0, rel_scale=50.0):
    """Reference weights; the relative-position tables scaled up so that
    their term moves the logits as much as ``q k`` does."""
    g = torch.Generator().manual_seed(seed)
    p = R.init_params(spec, g, "cpu")
    for k in p:
        if "rel_pos" in k:
            p[k] = p[k] * rel_scale
    return p


def gap(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.fixture(scope="module")
def narrow():
    p = params()
    img = torch.randn((R.IMG, R.IMG, 3), generator=torch.Generator(
    ).manual_seed(1))
    return p, img, R.encode(p, img, R.Precision())


def test_encoder_matches_the_reference(narrow):
    p, img, ref = narrow
    got = S.sam_encoder_forward(p, img)
    assert got.shape == ref.shape == (256, 64, 64)
    assert gap(got, ref) <= ENC_TOL
    tf32 = R.encode(p, img, R.Precision(tf32=True))
    assert gap(tf32, ref) > 10 * ENC_TOL


def test_a_global_block_run_windowed_is_another_encoder(narrow):
    p, img, ref = narrow
    assert gap(R.encode(p, img, R.Precision(), windowed=(3,)), ref) > 1e-2


@pytest.mark.parametrize("multimask", [True, False], ids=["multi", "single"])
def test_decoder_matches_the_reference(narrow, multimask):
    p, _, emb = narrow
    pts = torch.tensor([[10.0, 20.0], [500.0, 300.0], [1000.5, 3.0],
                        [640.0, 700.0]])
    labels = torch.ones((4, 1), dtype=torch.int32)
    sparse = S.encode_points(p, pts[:, None], labels)
    low, iou = S.mask_decoder_forward(p, emb, S.dense_pe(p), sparse,
                                      multimask=multimask,
                                      ln_eps=S.DECODER_LN_EPS)
    pe = R.dense_pe(p)
    ref = [R.decode(p, emb, pe, R.point_tokens(p, xy), R.Precision(),
                    multimask) for xy in pts]
    rlow = torch.stack([r[0] for r in ref])
    riou = torch.stack([r[1] for r in ref])
    m = 3 if multimask else 1
    assert low.shape == (4, m, 256, 256) and iou.shape == (4, m)
    assert gap(low, rlow) <= LOGIT_TOL
    assert float((iou - riou).abs().max()) <= IOU_TOL
    if multimask:
        t = [R.decode(p, emb, pe, R.point_tokens(p, xy),
                      R.Precision(tf32=True)) for xy in pts]
        assert gap(torch.stack([r[0] for r in t]), rlow) > 10 * LOGIT_TOL
        assert float((torch.stack([r[1] for r in t]) - riou).abs().max()) \
            > 10 * IOU_TOL


def test_upscale_and_preprocess_follow_the_reference():
    """The port's JAX-style resizes and the reference's ``F.interpolate``
    compute the same maps up to rounding."""
    g = torch.Generator().manual_seed(3)
    low = torch.randn((3, 256, 256), generator=g)
    # Readings 3.9e-7 (shrinking) and 1.9e-7 (enlarging, 1280x720).
    for orig, inp in (((48, 64), (768, 1024)), ((720, 1280), (576, 1024))):
        got = S.postprocess_masks(low[:, None], orig, inp)[:, 0]
        assert gap(got, R.upscale(low, orig, inp)) <= 2e-6
    pred = SP.SamBackend.__new__(SP.SamBackend)
    pred.device, pred.has_encoder = torch.device("cpu"), True
    pred.params = params(R.Spec(32, 1, 2, (0,)))
    img = torch.rand((90, 160, 3), generator=g) * 255
    pred.set_image(img.numpy())
    ref = R.encode(pred.params, R.preprocess(img), R.Precision())
    assert pred._input_hw == (576, 1024)
    assert gap(pred._embedding, ref) <= 1e-4


# ------------------------------------------------------------------ filter
def host_filter(lows, ious, pts, cfg, orig_hw, input_hw):
    """The automatic masks' filter as a host loop over the masks (the
    port's ``auto_segment`` before it moved to the device)."""
    h, w = orig_hw
    survivors, meta = [], []
    b = lows[0].shape[0]
    for bi, (low_t, iou_t) in enumerate(zip(lows, ious)):
        low, iou_a = low_t.numpy(), iou_t.numpy()
        for j in range(low.shape[0]):
            for mi in range(low.shape[1]):
                iou = float(iou_a[j, mi])
                if iou < cfg.pred_iou_thresh:
                    continue
                lg = low[j, mi]
                inter = float((lg > cfg.stability_offset).sum())
                union = float((lg > -cfg.stability_offset).sum())
                stab = inter / max(union, 1.0)
                if stab < cfg.stability_thresh:
                    continue
                survivors.append(lg)
                meta.append((iou, stab, [pts[bi * b + j].tolist()]))
    cands = []
    for s0 in range(0, len(survivors), 32):
        batch = torch.as_tensor(np.stack(survivors[s0:s0 + 32]))[:, None]
        masks = (S.postprocess_masks(batch, orig_hw, input_hw)
                 > 0.0)[:, 0].numpy()
        for mask, (iou, stab, pc) in zip(masks, meta[s0:s0 + 32]):
            area = int(mask.sum())
            if area < cfg.min_area:
                continue
            cands.append({"segmentation": mask, "area": area,
                          "predicted_iou": iou, "stability_score": stab,
                          "point_coords": pc, "crop_box": [0, 0, w, h]})
    cands.sort(key=lambda r: -r["predicted_iou"])
    kept = []
    for r in cands:
        keep = True
        for k in kept:
            inter = np.logical_and(r["segmentation"], k["segmentation"]).sum()
            union = np.logical_or(r["segmentation"], k["segmentation"]).sum()
            if union and inter / union > cfg.nms_iou:
                keep = False
                break
        if keep:
            ys, xs = np.where(r["segmentation"])
            r["bbox"] = [int(xs.min()), int(ys.min()),
                         int(xs.max() - xs.min()), int(ys.max() - ys.min())]
            kept.append(r)
    return kept


def blobs(seed, p=12, batch=4, size=256):
    """[p/batch] batches of [batch, 3, 256, 256] logits: discs around a few
    shared centres (so that masks overlap and repeat exactly), sharp or
    soft, and IoUs drawn from a few values (ties)."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(size, dtype=torch.float32),
                            torch.arange(size, dtype=torch.float32),
                            indexing="ij")
    centres = torch.rand((4, 2), generator=g) * size * 0.8 + size * 0.1
    low = torch.empty((p, 3, size, size))
    for i in range(p):
        for m in range(3):
            c = centres[int(torch.randint(4, (1,), generator=g))]
            r = 20.0 + 15.0 * m
            steep = float(torch.tensor([0.05, 0.5, 4.0])[
                torch.randint(3, (1,), generator=g)])
            d = torch.sqrt((yy - c[0]) ** 2 + (xx - c[1]) ** 2)
            low[i, m] = steep * (r - d)
    low[1] = low[0]                      # a prompt repeated exactly
    choices = torch.tensor([0.6, 0.75, 0.875, 0.9, 0.95])
    iou = choices[torch.randint(5, (p, 3), generator=g)]
    return list(low.split(batch)), list(iou.split(batch))


def same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            if k == "segmentation":
                assert np.array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def survivor_values(lows, ious, pts, cfg, orig_hw, input_hw):
    """Each mask's predicted IoU, stability, area, and the candidates'
    pairwise IoUs, as the host loop computes them."""
    loose = dataclasses.replace(cfg, pred_iou_thresh=-1.0,
                                stability_thresh=-1.0, min_area=0,
                                nms_iou=2.0)
    every = host_filter(lows, ious, pts, loose, orig_hw, input_hw)
    pair = []
    for i, a in enumerate(every):
        for b in every[:i]:
            inter = np.logical_and(a["segmentation"], b["segmentation"]).sum()
            union = np.logical_or(a["segmentation"], b["segmentation"]).sum()
            if union:
                pair.append(inter / union)
    return ([r["predicted_iou"] for r in every],
            [r["stability_score"] for r in every],
            [r["area"] for r in every], pair)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_filter_keeps_what_the_host_loop_kept(seed):
    lows, ious = blobs(seed)
    orig, inp = (60, 80), (768, 1024)
    pts = np.arange(2.0 * 12).reshape(12, 2)
    base = SP.AutoMaskConfig(points_per_side=0, points_per_batch=4,
                             pred_iou_thresh=0.7, stability_offset=1.0,
                             stability_thresh=0.5, nms_iou=0.7, min_area=20)
    iou_v, stab_v, area_v, pair_v = survivor_values(lows, ious, pts, base,
                                                    orig, inp)
    # Thresholds on values the data holds, so that equality decides.
    on = [base,
          dataclasses.replace(base, pred_iou_thresh=0.875,
                              stability_thresh=sorted(stab_v)[len(stab_v)
                                                              // 2]),
          dataclasses.replace(base, min_area=sorted(area_v)[len(area_v) // 3],
                              nms_iou=sorted(pair_v)[len(pair_v) // 2]),
          dataclasses.replace(base, pred_iou_thresh=0.0, stability_thresh=0.0,
                              min_area=1, nms_iou=0.0)]
    for cfg in on:
        want = host_filter(lows, ious, pts, cfg, orig, inp)
        got = SP.filter_masks(lows, ious, pts, cfg, orig, inp)
        same(got, want)
    assert any(len(host_filter(lows, ious, pts, c, orig, inp)) > 1
               for c in on)


def test_the_filter_with_nothing_past_it():
    lows, ious = blobs(4)
    cfg = SP.AutoMaskConfig(pred_iou_thresh=2.0)
    assert SP.filter_masks(lows, ious, np.zeros((12, 2)), cfg, (60, 80),
                           (768, 1024)) == []


# ------------------------------------------------------------ model choice
def test_vit_h_table_and_parameter_count():
    spec = SP.SAM_ENCODERS["vit_h"]
    assert spec == (1280, 32, 16, (7, 15, 23, 31), 14)
    assert SP.SAM_ENCODERS["vit_l"] == (1024, 24, 16, (5, 11, 17, 23), 14)
    assert SP.SAM_ENCODERS["vit_b"] == (768, 12, 12, (2, 5, 8, 11), 14)
    p = R.init_params(R.Spec(spec.dim, spec.depth, spec.num_heads,
                             spec.global_blocks, spec.window), None, "meta")
    assert p["enc.blocks.7.attn.rel_pos_h"].shape == (127, 80)
    assert p["enc.blocks.6.attn.rel_pos_h"].shape == (27, 80)
    n = R.parameter_count(p)
    assert abs(n - 636e6) < 0.01 * 636e6, n
    SP.check_encoder(p, "vit_h")
    with pytest.raises(ValueError, match="vit_b"):
        SP.check_encoder(p, "vit_b")


def test_a_vit_b_file_is_refused_as_vit_h(tmp_path):
    spec = SP.SAM_ENCODERS["vit_b"]
    path = tmp_path / "sam_vit_h.npz"
    np.savez(path, **{"enc.patch_embed.w": np.zeros((768, spec.dim),
                                                    np.float32),
                      "enc.n_blocks": np.asarray(spec.depth),
                      "enc.num_heads": np.asarray(spec.num_heads),
                      "enc.global_blocks": np.asarray(spec.global_blocks),
                      "enc.window": np.asarray(spec.window)})
    with pytest.raises(ValueError, match="vit_h"):
        SP.SamBackend(str(path), device="cpu", model="vit_h")
    with pytest.raises(ValueError, match="unknown SAM model"):
        SP.SamBackend(str(path), device="cpu", model="vit_x")
    with np.load(path) as data:
        SP.check_encoder(data, "vit_b")


def test_a_named_model_decodes_at_sams_layernorm_eps(tmp_path, monkeypatch):
    spec = R.Spec(32, 1, 2, (0,))
    monkeypatch.setitem(SP.SAM_ENCODERS, "vit_tiny",
                        SP.EncoderSpec(32, 1, 2, (0,)))
    path = tmp_path / "sam_vit_tiny.npz"
    np.savez(path, **{k: v.numpy() for k, v in params(spec).items()})
    pts = np.array([[10.0, 20.0], [60.0, 30.0]])
    img = (np.random.default_rng(1).uniform(0, 255, (48, 64, 3))
           ).astype(np.uint8)
    lows = {}
    for model, eps in ((None, 1e-6), ("vit_tiny", S.DECODER_LN_EPS)):
        be = SP.SamBackend(str(path), device="cpu", model=model)
        be.set_image(img)
        low, _ = be._decode_points(pts, True)
        sparse = S.encode_points(
            be.params, torch.as_tensor(pts, dtype=torch.float32)[:, None]
            * be._scale, torch.ones((2, 1), dtype=torch.int32))
        want, _ = S.mask_decoder_forward(be.params, be._embedding, be._pe,
                                         sparse, multimask=True, ln_eps=eps)
        assert torch.equal(low, want)
        lows[model] = low
    assert not torch.equal(lows[None], lows["vit_tiny"])


# ------------------------------------------------------ spans and counters
def test_auto_segment_records_its_spans_and_counters(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    spec = R.Spec(32, 2, 2, (1,))
    monkeypatch.setitem(SP.SAM_ENCODERS, "vit_tiny",
                        SP.EncoderSpec(32, 2, 2, (1,)))
    p = params(spec)
    np.savez(tmp_path / "sam_vit_tiny.npz",
             **{k: v.numpy() for k, v in p.items()})
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(tmp_path))
    from collab_splats_tpu_torch.features.segmentation import Segmentation

    cfg = SP.AutoMaskConfig(points_per_side=3, points_per_batch=4,
                            pred_iou_thresh=0.5, stability_thresh=0.0,
                            min_area=1)
    seg = Segmentation(device="cpu", sam_model="vit_tiny", auto_mask=cfg)
    assert seg.sam is not None and seg.sam.model == "vit_tiny"
    img = (np.random.default_rng(0).uniform(0, 255, (48, 64, 3))
           ).astype(np.uint8)
    untraced = seg.auto_segment_image(img)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        kept = seg.auto_segment_image(img)
    t = profiling.totals()
    same(kept, untraced)
    spans, counters = t["spans"], t["counters"]
    assert spans["sam.image"]["count"] == 1
    assert spans["sam.encode"]["count"] == 1
    assert spans["sam.decode"]["count"] == 3
    assert spans["sam.filter"]["parents"] == ["sam.image"]
    assert spans["sync.sam"]["parents"] == ["sam.filter"]
    assert counters["host_syncs"] == spans["sync.sam"]["count"] <= 2
    assert counters["sam.prompts"] == 9 and counters["sam.masks"] == 27
    assert counters["sam.kept"] == len(kept) <= counters["sam.candidates"]
    assert len(kept) > 0

"""The segmentation and query cells: SAM's operation counts by hand, the
two copies of the SAM reference, both loops end to end on the CPU at a
tiny size, their discovery by name, and the per-image and per-call span
arithmetic."""

import json
import statistics
from pathlib import Path

import pytest
import torch

from benchlib import sam_weights, spec, units
from conftest import BENCH, ROOT, run_cell, tiny_copy
from counts import sam as sam_counts

SEGMENT = "segment-sam-vit-h-720p"
QUERY = "query-rade-features-1m"


def test_the_two_copies_of_the_sam_reference_are_equal():
    assert (BENCH / "reference" / "sam.py").read_bytes() == \
        (ROOT / "tests" / "plain_sam.py").read_bytes()


def test_encoder_count_by_hand():
    # Width 8, 2 heads of 4, 2 blocks (block 1 global), window 3, a 4x4
    # grid of 2x2 patches, MLP ratio 2, neck to 4 channels.  The windowed
    # block pads 4 to 6: 36 tokens in 4 windows of 9.
    patch = 2 * 16 * 12 * 8
    windowed = (2 * 36 * 8 * 24 + 2 * 2 * 4 * 2 * 9 * 9 * 4
                + 2 * 2 * 36 * 2 * 3 * 4 + 2 * 36 * 8 * 8
                + 2 * 2 * 16 * 8 * 16)
    global_ = (2 * 16 * 8 * 24 + 2 * 2 * 1 * 2 * 16 * 16 * 4
               + 2 * 2 * 16 * 2 * 4 * 4 + 2 * 16 * 8 * 8
               + 2 * 2 * 16 * 8 * 16)
    neck = 2 * 16 * 8 * 4 + 2 * 16 * 4 * 4 * 9
    assert sam_counts.encoder(8, 2, 2, (1,), 3, grid=4, patch=2,
                              mlp_ratio=2, out=4) == \
        patch + windowed + global_ + neck


def test_decoder_count_by_hand():
    # Width 8, depth 1, MLP 16, cross attention at 4, 3 tokens, 2 mask
    # tokens, a 2x2 grid, upscaling to 2 then 1 channel.
    def attn(tq, tk, c):
        return 2 * (tq * 8 * c + 2 * tk * 8 * c + 2 * tq * tk * c
                    + tq * c * 8)

    layer = attn(3, 3, 8) + attn(3, 4, 4) + 2 * 2 * 3 * 8 * 16 \
        + attn(4, 3, 4)
    up = 2 * 16 * 2 * 8 + 2 * 64 * 1 * 2
    heads = 2 * (2 * (8 * 8 * 2) + 2 * 8 * 1) + 2 * (8 * 8 * 2) + 2 * 8 * 2
    masks = 2 * 2 * 1 * 64
    assert sam_counts.decoder_per_prompt(
        8, 1, 16, 2, tokens=3, mask_tokens=2, grid=2, upscale=(2, 1)) == \
        layer + attn(3, 4, 4) + up + heads + masks


def test_the_configuration_counts_about_ten_teraflops():
    cfg = json.loads((BENCH / "configs" / "sam-vit-h.json").read_text())
    ops = sam_counts.image(cfg)
    assert sam_counts.encoder(1280, 32, 16, (7, 15, 23, 31), 14) == \
        pytest.approx(5.96e12, rel=1e-3)
    assert sam_counts.decoder_per_prompt() == pytest.approx(3.62e9,
                                                            rel=1e-3)
    assert ops == sam_counts.encoder(1280, 32, 16, (7, 15, 23, 31), 14) \
        + 1024 * sam_counts.decoder_per_prompt()


def test_the_new_cells_mixes_and_metrics_are_found_by_name():
    for cell, loop, metrics in (
            (SEGMENT, "segment", {"encode_card_ms.segment",
                                  "decode_card_ms.segment",
                                  "filter_card_ms.segment",
                                  "host_syncs.segment", "idle_pct.segment",
                                  "mfu.segment"}),
            (QUERY, "query", {"similarity_card_ms.query", "idle_pct.query",
                              "project_card_ms.query", "host_syncs.query",
                              "spill_pct.query",
                              "project_fused_pct.query"})):
        c = spec.find(ROOT, BENCH, cell)
        assert c.traffic["loop"] == loop and c.chips == 1
        assert {m["name"] for m in c.end_to_end} == {"setup_s", "step_ms"}
        assert {m["name"] for m in c.per_layer} == metrics
        assert set(spec.readers(c)) == metrics
        assert spec.loop(c).run


def test_unit_arithmetic(monkeypatch):
    t = {"spans": {"sam.image": {"count": 4, "card_s": 1.0},
                   "sam.encode": {"count": 4, "card_s": 0.6},
                   "query.similarity": {"count": 8, "card_s": 0.016}},
         "counters": {"host_syncs": 8.0}}
    monkeypatch.setattr(units, "totals", lambda: t)
    seg = {"kind": "segment"}
    assert units.card_ms_per_unit(seg, "segment", "sam.encode",
                                  "sam.image") == pytest.approx(150.0)
    assert units.count_per_unit(seg, "segment", "host_syncs",
                                "sam.image") == 2.0
    assert units.card_ms_per_unit({"kind": "query"}, "query",
                                  "query.similarity",
                                  "query.similarity") == pytest.approx(2.0)
    assert units.card_ms_per_unit(seg, "query", "sam.encode",
                                  "sam.image") is None
    assert units.card_ms_per_unit(seg, "segment", "sam.decode",
                                  "sam.image") is None
    assert units.count_per_unit(seg, "segment", "sam.kept",
                                "sam.image") is None
    assert units.count_per_unit(seg, "segment", "sam.kept", "sam.image",
                                absent=0.0) == 0.0
    monkeypatch.setattr(units, "totals", lambda: None)
    assert units.count_per_unit(seg, "segment", "host_syncs",
                                "sam.image") is None
    assert units.count_per_unit(seg, "segment", "host_syncs", "sam.image",
                                absent=0.0) is None


# ------------------------------------------------------ the loops on CPU
TINY_SEGMENT = {"frames": 3, "width": 64, "height": 48, "check_images": 2,
                "trace_images": 1}
TINY_QUERY = {"n_alive": 300, "capacity": 512, "views": 4, "width": 64,
              "height": 48, "focal": 64.0, "scale_range": [0.02, 0.06],
              "check_queries": 2, "trace_queries": 2}
TINY_DIMS = {"clip-vit": [32, 6, 8], "dinov2": [16, 6, 8]}
LIMITS = {SEGMENT: {"embed_gap": 1e-4, "logit_gap": 1e-4, "iou_gap": 1e-5,
                    "kept_mismatch": 0.0},
          QUERY: {"map_gap": 1e-4, "map_max_gap": 1e-2}}


def _update(path: Path, fn):
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


@pytest.fixture
def tiny_sam_root(tmp_path, monkeypatch):
    """A tiny checkout: SAM 32 wide (2 blocks, the second global) under a
    model name the program is given for the test, 2x2 prompts on 64x48
    frames; the query on 300 Gaussians at 64x48 with narrow towers."""
    from collab_splats_tpu_torch.features import sam_predictor

    root = tiny_copy(tmp_path)
    bench = root / BENCH.name
    monkeypatch.setitem(sam_predictor.SAM_ENCODERS, "vit_tiny",
                        sam_predictor.EncoderSpec(32, 2, 2, (1,)))

    def sam_cfg(c):
        c["model"] = "vit_tiny"
        c["image_encoder"].update(embed_dim=32, depth=2, num_heads=2,
                                  global_attn_indexes=[1])
        c["auto_mask"].update(points_per_side=2, points_per_batch=3,
                              pred_iou_thresh=0.5, stability_thresh=0.0,
                              min_area=1)

    _update(bench / "configs" / "sam-vit-h.json", sam_cfg)
    _update(bench / "traffic" / "segment-720p.json",
            lambda t: t.update(TINY_SEGMENT))
    _update(bench / "traffic" / "query-1m.json",
            lambda t: t.update(TINY_QUERY))

    def narrow(c):
        c["method_kwargs"]["feature_dims"] = TINY_DIMS
        c["model"]["feature_dims"] = TINY_DIMS

    _update(bench / "configs" / "rade-features.json", narrow)
    for cell, lim in LIMITS.items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(
            {k: {"limit": v} for k, v in lim.items()}))
    return root


def _with_device(monkeypatch):
    """The CPU's trace with one device operation over the window."""
    from benchlib import trace

    real = trace.from_profiler

    def with_device(prof):
        ev = real(prof)
        w = next(e for e in ev if e.name == trace.WINDOW_SPAN)
        return ev + [trace.Event("kernel", True, w.start_us, w.end_us)]

    monkeypatch.setattr(trace, "from_profiler", with_device)


def test_the_segment_loop_runs_and_checks_on_the_cpu(tiny_sam_root, capsys):
    code, line = run_cell(tiny_sam_root, SEGMENT, capsys=capsys)
    assert code == 0 and line is not None
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "step_ms"}
    assert set(line["compared"]) == set(LIMITS[SEGMENT])
    assert not (tiny_sam_root / "build" / "bench_cache").exists() or not \
        list((tiny_sam_root / "build" / "bench_cache").glob("sam-*"))


def test_the_segment_loop_traces_its_metrics(tiny_sam_root, capsys,
                                             monkeypatch):
    import run as harness

    _with_device(monkeypatch)
    code = harness.main(["--workload", SEGMENT, "--seed", "2147483651",
                         "--seconds", "0.2", "--trace", "1"],
                        root=tiny_sam_root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and line["correct"]
    m = line["metrics"]
    # Card times need a card: none on the CPU.
    assert set(m) == {"host_syncs.segment", "mfu.segment",
                      "idle_pct.segment"}
    assert 1.0 <= m["host_syncs.segment"]["value"] <= 2.0
    assert m["mfu.segment"]["value"] > 0


def test_the_query_loop_traces_its_metrics(tiny_sam_root, capsys,
                                           monkeypatch):
    import run as harness

    _with_device(monkeypatch)
    code = harness.main(["--workload", QUERY, "--seed", "2147483653",
                         "--seconds", "0.2", "--trace", "1"],
                        root=tiny_sam_root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and line["correct"]
    m = line["metrics"]
    # Card times need a card: none on the CPU, where the projection is
    # the plain one (no fused rows).
    assert set(m) == {"idle_pct.query", "host_syncs.query",
                      "spill_pct.query", "project_fused_pct.query"}
    assert m["host_syncs.query"]["value"] == 0.0
    assert m["project_fused_pct.query"]["value"] == 0.0
    assert 0.0 <= m["spill_pct.query"]["value"] < 100.0


def test_the_query_loop_runs_and_checks_on_the_cpu(tiny_sam_root, capsys):
    code, line = run_cell(tiny_sam_root, QUERY, seed=2147483651,
                          capsys=capsys)
    assert code == 0 and line is not None
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["compared"]) == {"map_gap", "map_max_gap"}


def test_a_wrong_query_is_caught(tiny_sam_root):
    """The query loop's check tells the next positive from the query's
    own."""
    import argparse
    import time

    import run as harness
    from loops import query
    from reference.precision import Products

    cell = spec.find(tiny_sam_root, tiny_sam_root / BENCH.name, QUERY)
    ctx = harness.Context(argparse.Namespace(seed=3, seconds=0.0, trace=0),
                          cell, "cpu", time.perf_counter())
    prog, maps = query.setup(ctx)
    views = [prog.view(j) for j in range(len(maps))]
    good = query.numbers(maps, query.reference_maps(ctx, views,
                                                    Products(False)))
    bad = query.numbers(maps, query.reference_maps(ctx, views,
                                                   Products(False), shift=1))
    assert good["map_gap"] <= LIMITS[QUERY]["map_gap"]
    assert bad["map_gap"] > 100 * good["map_gap"]
    assert torch.is_tensor(prog.emb)


# -------------------------------------------------- the seeded decoder
def _localised(seed):
    from reference import sam as R

    p = R.init_params(R.Spec(32, 1, 2, (0,)),
                      torch.Generator().manual_seed(seed), "cpu")
    sam_weights.localise(p, torch.Generator().manual_seed(seed + 100))
    return p


def _hash_iou(p, pts1024):
    """The predicted IoU that ``sam_weights`` builds, from the point's
    encoding alone: 0.88 + slope (tau - z), z the hash's sum."""
    from collab_splats_tpu_torch.features import sam as S

    pe = S.encode_points(p, pts1024[:, None], torch.ones(
        (len(pts1024), 1), dtype=torch.int32))[:, 0] \
        - p["prompt.point_embed.1"]
    h = torch.tensor(sam_weights.HASH)
    amp = 16.0 / sam_weights.HASH_FREQS ** 0.5
    z = (amp * pe[:, h]) @ p["dec.iou_head.w0"][h, 1:4]
    tau = statistics.NormalDist().inv_cdf(sam_weights.PASS_SHARE)
    return 0.88 + sam_weights.IOU_SLOPE * (tau - z)


@pytest.mark.parametrize("seed", [1, 2])
def test_seeded_masks_are_nested_blobs_around_their_points(seed):
    from collab_splats_tpu_torch.features import sam as S
    from benchlib import scene

    p = _localised(seed)
    frame = scene.smooth_images(seed, 1, 720, 1280, "cpu")[0] * 255.0
    img = torch.zeros((1024, 1024, 3))
    img[:576] = (S.resize_bilinear(frame, (576, 1024))
                 - torch.tensor([123.675, 116.28, 103.53])) \
        / torch.tensor([58.395, 57.12, 57.375])
    emb = S.sam_encoder_forward(p, img)
    pts = torch.tensor([[100.0, 60.0], [640.0, 360.0], [1200.0, 700.0],
                        [300.0, 500.0], [900.0, 200.0]]) * 0.8
    low, iou = S.mask_decoder_forward(
        p, emb, S.dense_pe(p), S.encode_points(
            p, pts[:, None], torch.ones((5, 1), dtype=torch.int32)),
        multimask=True, ln_eps=S.DECODER_LN_EPS)
    yy, xx = torch.meshgrid(torch.arange(256.0), torch.arange(256.0),
                            indexing="ij")
    for i, (x, y) in enumerate((pts / 4.0).tolist()):
        d = torch.hypot(xx + 0.5 - x, yy + 0.5 - y)
        areas = []
        for m in range(3):
            lg = low[i, m]
            assert lg[int(y), int(x)] > 1.0
            assert bool((lg[d > 48.0] < -1.0).all())
            inter = float((lg > 1.0).sum())
            assert inter / float((lg > -1.0).sum()) >= 0.95
            areas.append(inter)
        assert areas[0] < 0.7 * areas[1] and areas[1] < 0.7 * areas[2]
        assert areas[2] < 0.06 * 256 * 144
    # The decoder's IoU is the hash's, up to the rest of the weights.
    assert float((iou - _hash_iou(p, pts)).abs().max()) < 2e-3


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2147483651, 2147483653])
def test_about_one_mask_in_twenty_passes_the_iou_threshold(seed):
    p = _localised(seed)
    g = (torch.arange(32.0) + 0.5) / 32
    gy, gx = torch.meshgrid(g * 720, g * 1280, indexing="ij")
    pts = torch.stack([gx, gy], dim=-1).reshape(-1, 2) * 0.8
    share = (_hash_iou(p, pts) >= 0.88).double().mean(0)
    assert bool(((share > 0.02) & (share < 0.09)).all()), share
    assert 60 <= 1024 * float(share.sum()) <= 280

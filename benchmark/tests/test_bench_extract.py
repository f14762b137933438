"""The extraction cell: the towers' operation counts by hand, the two
copies of the tower reference, the cell's discovery by name, and its loop
end to end on the CPU with both towers cut to a narrow width (the frames
at the cell's 1280x720, so the towers see the cell's token grids)."""

import json
from pathlib import Path

import pytest

from benchlib import spec
from conftest import BENCH, ROOT, run_cell, tiny_copy
from counts import vit as vit_counts

CELL = "extract-maskclip-dinov2-720p"
CONFIG = "maskclip-l14-336-dinov2-s14"
METRICS = {"clip_card_ms.extract", "dinov2_card_ms.extract",
           "attention_card_ms.extract", "idle_pct.extract", "mfu.extract"}
LIMITS = {"clip_gap": 2e-5, "dino_gap": 1e-4, "shape_mismatch": 0.0}


def test_the_two_copies_of_the_tower_reference_are_equal():
    assert (BENCH / "reference" / "vit.py").read_bytes() == \
        (ROOT / "tests" / "plain_vit.py").read_bytes()


def test_tower_counts_by_hand():
    # 5 tokens (4 patches and the class token), width 8, MLP 16, patch 2.
    blk = 2 * 5 * 8 * 24 + 2 * 2 * 5 * 5 * 8 + 2 * 5 * 8 * 8 \
        + 2 * 2 * 5 * 8 * 16
    assert vit_counts.block(5, 8, 16) == blk
    embed = 2 * 4 * 2 * 2 * 3 * 8
    last = 2 * 2 * 5 * 8 * 8 + 2 * 2 * 5 * 8 * 16
    assert vit_counts.maskclip(5, 8, 3, 16, 2, 4) == \
        embed + 2 * blk + last + 2 * 5 * 8 * 4
    assert vit_counts.dinov2(5, 8, 3, 16, 2) == embed + 3 * blk


def test_the_configuration_counts_about_two_point_eight_teraflops():
    cfg = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    assert vit_counts.grid(720, 1280, 1024, 14) == (41, 73)
    assert vit_counts.grid(720, 1280, 800, 14) == (32, 57)
    assert vit_counts.tokens(cfg, "clip", 720, 1280) + \
        vit_counts.tokens(cfg, "dinov2", 720, 1280) == 4819
    assert vit_counts.image(cfg, 720, 1280) == pytest.approx(2.788e12,
                                                             rel=1e-3)


def test_the_cell_its_mix_and_metrics_are_found_by_name():
    c = spec.find(ROOT, BENCH, CELL)
    assert c.traffic["loop"] == "extract" and c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "step_ms"}
    assert {m["name"] for m in c.per_layer} == METRICS
    assert set(spec.readers(c)) == METRICS
    assert set(LIMITS) <= set(c.limits)
    assert spec.loop(c).run


# ------------------------------------------------------ the loop on CPU
def _update(path: Path, fn):
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


@pytest.fixture
def tiny_extract_root(tmp_path):
    """A tiny checkout: both towers 64 wide with one head and 2 blocks, a
    small text tower, 3 frames at 1280x720."""
    root = tiny_copy(tmp_path)
    bench = root / BENCH.name

    def narrow(c):
        c["clip"].update(width=64, layers=2, heads=1, mlp_width=256,
                         embed_dim=48)
        c["clip"]["text"].update(width=64, layers=1, heads=1,
                                 vocab_size=600)
        c["dinov2"].update(width=64, layers=2, heads=1, mlp_width=256)

    _update(bench / "configs" / f"{CONFIG}.json", narrow)
    _update(bench / "traffic" / "extract-720p.json",
            lambda t: t.update(frames=3, check_images=2, trace_images=1))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(
        {k: {"limit": v} for k, v in LIMITS.items()}))
    return root


def test_the_extract_loop_runs_and_checks_on_the_cpu(tiny_extract_root,
                                                     capsys):
    code, line = run_cell(tiny_extract_root, CELL, seed=2147483655,
                          capsys=capsys)
    assert code == 0 and line is not None
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "step_ms"}
    assert set(line["compared"]) == set(LIMITS)
    assert line["compared"]["shape_mismatch"]["value"] == 0.0
    cache = tiny_extract_root / "build" / "bench_cache"
    assert not cache.exists() or not list(cache.glob("vit-*"))


def test_the_extract_loop_traces_its_metrics(tiny_extract_root, capsys,
                                             monkeypatch):
    import run as harness
    from benchlib import trace

    real = trace.from_profiler

    def with_device(prof):
        ev = real(prof)
        w = next(e for e in ev if e.name == trace.WINDOW_SPAN)
        return ev + [trace.Event("kernel", True, w.start_us, w.end_us)]

    monkeypatch.setattr(trace, "from_profiler", with_device)
    code = harness.main(["--workload", CELL, "--seed", "2147483657",
                         "--seconds", "0.2", "--trace", "1"],
                        root=tiny_extract_root, device="cpu")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert code == 0 and line["correct"]
    # Card times need a card: none on the CPU.
    assert set(line["metrics"]) == {"idle_pct.extract", "mfu.extract"}
    assert line["metrics"]["mfu.extract"]["value"] > 0
    assert "vit.tokens per image 4819.0" in err


def test_a_fault_is_caught(tiny_extract_root):
    """The loop's check tells each of the reference's faults from the
    reference by the number that the fault moves."""
    import argparse
    import time

    import run as harness
    from loops import extract

    cell = spec.find(tiny_extract_root, tiny_extract_root / BENCH.name, CELL)
    ctx = harness.Context(argparse.Namespace(seed=3, seconds=0.0, trace=0),
                          cell, "cpu", time.perf_counter())
    dm, fs = extract.setup(ctx)
    got = extract.slots(dm, 1)
    del dm
    extract.free(ctx)
    p = extract.weights(ctx)
    R = extract.R
    ref = extract.reference_maps(ctx, p, fs[:1], R.Precision())
    good = extract.compare(got, ref)
    assert good["clip_gap"] <= LIMITS["clip_gap"]
    assert good["dino_gap"] <= LIMITS["dino_gap"]
    assert good["shape_mismatch"] == 0.0
    for fault, key in (("attention_head", "clip_gap"),
                       ("bilinear_positions", "clip_gap"),
                       ("bilinear_positions", "dino_gap"),
                       ("no_layer_scale", "dino_gap"),
                       ("no_final_resize", "shape_mismatch")):
        bad = extract.compare(extract.reference_maps(
            ctx, p, fs[:1], R.Precision(), fault), ref)
        assert bad[key] > 10 * max(good[key], 1e-6), (fault, key)

"""The densify cell: its discovery by name, the plain refine against
rows worked by hand, and the loop end to end on the CPU at a tiny size,
with its check, a fault and its traced metrics."""

import argparse
import json
import time

import pytest
import torch

from benchlib import spec
from conftest import BENCH, ROOT, TINY, run_cell, tiny_copy
from reference import densify as RD

DENSIFY = "train-rade-gs-1m-densify"
METRICS = {"refine_card_ms.densify", "split_per_refine.densify",
           "update_card_ms.densify", "adam_fused_pct.densify",
           "idle_pct.densify"}
LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2,
          "alive_mismatch": 0.0, "refine_mismatch": 0.0}
# The train cells' tiny scene; restarts every 4 steps, two traced steps
# across the refine at 7,100.
TINY_DENSIFY = dict(TINY["train-1m"], restart_every=4, trace_from=7099)
STRATEGY = json.loads((BENCH / "configs" / "rade-gs.json").read_text())[
    "strategy"]


def test_the_cell_its_mix_and_metrics_are_found_by_name():
    c = spec.find(ROOT, BENCH, DENSIFY)
    assert c.traffic["loop"] == "densify" and c.chips == 1
    assert c.traffic["start_step"] == 7098
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "step_ms"}
    assert {m["name"] for m in c.per_layer} == METRICS
    assert set(spec.readers(c)) == METRICS
    assert spec.loop(c).run


def _table(n):
    return {"means": torch.zeros(n, 3), "scales": torch.full((n, 3), -6.0),
            "quats": torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
            "opacities": torch.full((n, 1), 2.0),
            "features_dc": torch.arange(n, dtype=torch.float32)[:, None]
            .repeat(1, 3)}


@pytest.mark.parametrize("capacity, written", [(8, [2, 5, 6]),
                                               (6, [2, 5]), (5, [])])
def test_refine_by_hand(capacity, written):
    """Rows 0-4 alive: 0 a large high-gradient row (split), 1 a small one
    (duplicated), 2 faint (culled), 3 and 4 quiet.  The free rows are 2
    (culled) and 5 onwards: the split's two children first, then the
    duplicate; with one free row fewer the duplicate is dropped, with
    two fewer the split does not fit either and its source stays."""
    p = _table(capacity)
    p["scales"][0] = -3.0                      # 0.0498 > 0.01
    p["opacities"][2] = -5.0                   # culled
    alive = torch.zeros(capacity, dtype=torch.bool)
    alive[:5] = True
    grad = torch.zeros(capacity)
    grad[:2] = 0.01
    count = torch.ones(capacity)
    noise = torch.ones(2, capacity, 3)
    r = RD.refine(p, alive, grad, count, torch.zeros(capacity), noise,
                  7100, STRATEGY, 1.0, 64)
    assert r.split.tolist()[:2] == [True, False]
    assert r.duplicated.tolist()[:2] == [False, True]
    assert r.culled.tolist()[:3] == [False, False, True]
    assert torch.nonzero(r.written).flatten().tolist() == written
    assert bool(r.alive[0]) == (not written)
    assert r.alive[[1, 3, 4]].all() and bool(r.alive[2]) == bool(written)
    if written:
        child = torch.exp(torch.tensor(-3.0))
        assert torch.allclose(r.params["means"][2], torch.full((3,), child))
        assert torch.allclose(r.params["scales"][5],
                              torch.log(torch.full((3,), child / 1.6)))
    if len(written) == 3:
        assert float(r.params["features_dc"][6, 0]) == 1.0


@pytest.fixture
def tiny_densify_root(tmp_path):
    root = tiny_copy(tmp_path, LIMITS)
    path = root / BENCH.name / "traffic" / "train-1m-densify.json"
    t = json.loads(path.read_text())
    t.update(TINY_DENSIFY)
    path.write_text(json.dumps(t))
    return root


def test_the_densify_loop_runs_and_checks_on_the_cpu(tiny_densify_root,
                                                     capsys):
    code, line = run_cell(tiny_densify_root, DENSIFY, seed=2147483653,
                          capsys=capsys)
    assert code == 0 and line is not None
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["compared"]) == set(LIMITS)


def test_the_densify_loop_traces_its_metrics(tiny_densify_root, capsys,
                                             monkeypatch):
    import run as harness
    from benchlib import trace

    real = trace.from_profiler

    def with_device(prof):
        ev = real(prof)
        w = next(e for e in ev if e.name == trace.WINDOW_SPAN)
        return ev + [trace.Event("kernel", True, w.start_us, w.end_us)]

    monkeypatch.setattr(trace, "from_profiler", with_device)
    code = harness.main(["--workload", DENSIFY, "--seed", "11",
                         "--seconds", "0.2", "--trace", "1"],
                        root=tiny_densify_root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and line["correct"]
    m = line["metrics"]
    # Card times need a card; on the CPU no row is fused.
    assert set(m) == {"split_per_refine.densify", "adam_fused_pct.densify",
                      "idle_pct.densify"}
    assert m["split_per_refine.densify"]["value"] > 0
    assert m["adam_fused_pct.densify"]["value"] == 0.0


def test_a_refine_left_out_is_caught(tiny_densify_root):
    import run as harness
    from loops import densify
    from reference.precision import Products

    cell = spec.find(tiny_densify_root, tiny_densify_root / BENCH.name,
                     DENSIFY)
    ctx = harness.Context(argparse.Namespace(seed=3, seconds=0.0, trace=0),
                          cell, "cpu", time.perf_counter())
    tr, _, prog, refines = densify.setup(ctx)
    n = len(prog[0])
    del tr
    good = densify.numbers(ctx, prog, refines, densify.reference_readings(
        ctx, refines, n, Products(False)))
    bad = densify.numbers(ctx, prog, refines, densify.reference_readings(
        ctx, refines, n, Products(False), densify=False))
    assert all(v <= LIMITS[k] for k, v in good.items()), good
    assert bad["alive_mismatch"] > 0 and bad["change_gap"] > 10 * max(
        good["change_gap"], 1e-6)

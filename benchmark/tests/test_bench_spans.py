"""The readers of the program's own spans and counters (``benchlib/spans.py``
and its six ``metrics/`` files): None on an empty log, the right value on
a synthetic one, and on a traced CPU run the counters without the card
times."""

import json

import pytest

import run as harness
from benchlib import spans, spec, trace
from conftest import BENCH

SPAN_METRICS = ("project_card_ms.train", "backward_card_ms.train",
                "update_card_ms.train")
COUNTER_METRICS = ("host_syncs.train", "rows_per_alive.train",
                   "spill_pct.train")
LAYER = {"kind": "train", "units": 4}


def reader(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py",
                            "test_metric_" + name.replace(".", "_")).read


def span(count, card_s):
    return {"count": count, "host_s": 1.0, "self_host_s": 0.5,
            "card_s": card_s, "parents": [None]}


# Four steps: 2 reads each, 2.5M rows a render over 1M alive, 3 of 300
# intersections cut.
SYNTHETIC = {
    "spans": {"train.step": span(4, 0.280), "render.project": span(4, 0.040),
              "train.backward": span(4, 0.140),
              "train.update": span(4, 0.024)},
    "counters": {"host_syncs": 8.0, "render.rows": 4 * 2.5e6,
                 "render.alive": 4 * 1e6, "render.pairs": 300.0,
                 "render.spilled": 3.0},
}
EXPECTED = {"project_card_ms.train": 10.0, "backward_card_ms.train": 35.0,
            "update_card_ms.train": 6.0, "host_syncs.train": 2.0,
            "rows_per_alive.train": 2.5, "spill_pct.train": 1.0}


@pytest.mark.parametrize("name", SPAN_METRICS + COUNTER_METRICS)
def test_none_on_an_empty_log(name):
    from collab_splats_tpu_torch.utils import profiling

    profiling.reset()
    assert reader(name)(LAYER) is None


@pytest.mark.parametrize("name", SPAN_METRICS + COUNTER_METRICS)
def test_value_on_a_synthetic_log(name, monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: SYNTHETIC)
    assert reader(name)(LAYER) == pytest.approx(EXPECTED[name])
    assert reader(name)({"kind": "view", "units": 4}) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_card_time_reads_none(name, monkeypatch):
    log = json.loads(json.dumps(SYNTHETIC))
    for s in log["spans"].values():
        s["card_s"] = None
    monkeypatch.setattr(spans, "totals", lambda: log)
    assert reader(name)(LAYER) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    from collab_splats_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "totals")
    assert spans.totals() is None
    for name in SPAN_METRICS + COUNTER_METRICS:
        assert reader(name)(LAYER) is None


def test_a_traced_cpu_run_prints_the_counters(tiny_root, capsys,
                                              monkeypatch):
    """The CPU has no device trace: the window's summary is a stand-in, so
    that the run reaches its readers."""
    from collab_splats_tpu_torch.utils import profiling

    monkeypatch.setattr(trace, "summarize", lambda events: trace.TraceSummary(
        1.0, 0.5, {}, {}, {}))
    layers = []
    real = spans.count_per_step

    def watch(layer, *a):
        layers.append(layer)
        return real(layer, *a)

    monkeypatch.setattr(spans, "count_per_step", watch)
    profiling.reset()
    code = harness.main(["--workload", "train-rade-gs-1m", "--seed",
                         str(2 ** 31 + 11), "--seconds", "0.5", "--trace",
                         "1"], root=tiny_root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and line["correct"]
    metrics = line["metrics"]
    assert set(COUNTER_METRICS) <= set(metrics)
    assert not set(SPAN_METRICS) & set(metrics)
    totals = profiling.totals()
    assert totals["spans"]["train.step"]["count"] == layers[0]["units"]
    assert metrics["host_syncs.train"]["value"] == 2.0
    c = totals["counters"]
    assert metrics["rows_per_alive.train"]["value"] == pytest.approx(
        c["render.rows"] / c["render.alive"])
    assert metrics["rows_per_alive.train"]["value"] > 1.0
    assert metrics["spill_pct.train"]["unit"] == "%"

"""The reader of ``adam_fused_pct.train``: the share of Adam's elements that
the fused update kernel ran over, from the program's counters
``train.adam_fused_elems`` and ``train.adam_elems``: the expected share
from counters given by hand, nothing where the counters are missing, and 0
on a traced CPU run, where the plain update runs."""

import json

import pytest

import run as harness
from benchlib import spans, trace
from test_bench_spans import LAYER, SYNTHETIC, reader

NAME = "adam_fused_pct.train"
# Four steps of the rade-gs table: 148,932,992 elements each.
ELEMS = 4 * 148_932_992


@pytest.mark.parametrize("fused,want", [(ELEMS, 100.0), (ELEMS // 4, 25.0),
                                        (0, 0.0)])
def test_share_from_counters_given_by_hand(fused, want, monkeypatch):
    log = json.loads(json.dumps(SYNTHETIC))
    log["counters"].update({"train.adam_elems": float(ELEMS),
                            "train.adam_fused_elems": float(fused)})
    monkeypatch.setattr(spans, "totals", lambda: log)
    assert reader(NAME)(LAYER) == pytest.approx(want)
    assert reader(NAME)({"kind": "view", "units": 4}) is None
    # A program without the counters (the parent of this metric): nothing.
    monkeypatch.setattr(spans, "totals", lambda: SYNTHETIC)
    assert reader(NAME)(LAYER) is None


def test_a_traced_cpu_run_reads_0(tiny_root, capsys, monkeypatch):
    """The CPU runs the plain update: every element counted, none fused."""
    from collab_splats_tpu_torch.utils import profiling

    monkeypatch.setattr(trace, "summarize", lambda events: trace.TraceSummary(
        1.0, 0.5, {}, {}, {}))
    profiling.reset()
    code = harness.main(["--workload", "train-rade-gs-1m", "--seed",
                         str(2 ** 31 + 25), "--seconds", "0.5", "--trace",
                         "1"], root=tiny_root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and line["correct"]
    c = profiling.totals()["counters"]
    assert c["train.adam_elems"] > 0 and c["train.adam_fused_elems"] == 0
    metric = line["metrics"][NAME]
    assert metric["value"] == 0.0 and metric["unit"] == "%"

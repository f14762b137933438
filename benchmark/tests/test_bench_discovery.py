"""A new configuration, traffic mix and per-layer metric are new files and
new entries: the harness finds them by name with no other edit."""

import json
import shutil

from benchlib import spec
from conftest import BENCH, run_cell


def add_cell(root):
    """Add the configuration ``splatfacto-cfg``, the mix ``tiny-mix``, the
    metric ``steps_seen.train`` and the cell ``train-splatfacto-tiny``
    as files and entries only."""
    bench_dir = root / BENCH.name
    cfg = json.loads((bench_dir / "configs" / "rade-gs.json").read_text())
    cfg["method"] = "splatfacto"
    cfg["model"]["use_depth_normal_loss"] = False
    (bench_dir / "configs" / "splatfacto-cfg.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "train-1m.json").read_text())
    mix.update(n_alive=150, capacity=256, width=32, height=32, focal=32.0)
    (bench_dir / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "steps_seen.train.py").write_text(
        "def read(layer):\n"
        "    return float(layer['units']) if layer['kind'] == 'train' "
        "else None\n")
    shutil.copy(bench_dir / "limits" / "train-rade-gs-1m.json",
                bench_dir / "limits" / "train-splatfacto-tiny.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "splatfacto-cfg", "source": "x",
                         "file": f"{BENCH.name}/configs/splatfacto-cfg.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "train-splatfacto-tiny",
                           "config": "splatfacto-cfg", "traffic": "tiny-mix",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "steps_seen.train", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "step_ms",
                           "workloads": ["train-splatfacto-tiny"]})
    for m in b["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append("train-splatfacto-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_new_files_and_entries_make_a_new_cell(tiny_root, capsys):
    add_cell(tiny_root)
    cell = spec.find(tiny_root, tiny_root / BENCH.name,
                     "train-splatfacto-tiny")
    assert cell.config["method"] == "splatfacto"
    assert cell.traffic["n_alive"] == 150
    assert [m["name"] for m in cell.per_layer][-1] == "steps_seen.train"
    assert spec.readers(cell)["steps_seen.train"](
        {"kind": "train", "units": 7}) == 7.0
    code, line = run_cell(tiny_root, "train-splatfacto-tiny", capsys=capsys)
    assert code == 0 and line["correct"]
    assert set(line["metrics"]) == {"setup_s", "step_ms"}


def test_cells_report_their_own_metrics(tiny_root):
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        cell = spec.find(tiny_root, tiny_root / BENCH.name, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)


def test_an_unknown_cell_is_refused(tiny_root):
    import pytest

    with pytest.raises(KeyError):
        spec.find(tiny_root, tiny_root / BENCH.name, "no-such-cell")

"""Finding a cell's files by the names in ``BENCHMARK.json``.

A configuration is its ``file``; a traffic mix is
``traffic/<traffic>.json``, whose ``loop`` names ``loops/<loop>.py``;
a cell's limits are ``limits/<cell>.json``; a per-layer metric is the
reader ``metrics/<metric>.py``.  A new cell, mix or metric is new files and
new entries, and no edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]   # the cell's end-to-end metrics
    per_layer: List[dict]    # the cell's per-layer metrics
    bench_dir: Path


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find(root: Path, bench_dir: Path, cell: str) -> Cell:
    """The cell ``cell`` of ``root/BENCHMARK.json`` with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" /
                          f"{w['traffic']}.json").read_text())
    limits_path = bench_dir / "limits" / f"{cell}.json"
    limits = json.loads(limits_path.read_text()) \
        if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _reports(m, cell, names)]
    return Cell(cell, int(w["chips"]), config, traffic, limits, e2e, layer,
                bench_dir)


def loop(cell: Cell):
    """The module that runs the cell's traffic mix."""
    name = cell.traffic["loop"]
    return load_module(cell.bench_dir / "loops" / f"{name}.py",
                       f"loops.{name}")


def readers(cell: Cell) -> Dict[str, object]:
    """Each per-layer metric's ``read`` function, by name."""
    return {m["name"]: load_module(
        cell.bench_dir / "metrics" / f"{m['name']}.py",
        "metric_" + m["name"].replace(".", "_").replace("-", "_")).read
        for m in cell.per_layer}

"""Test set-up of the benchmark's own tests: the benchmark's folder and the
repository root on ``sys.path``, torch on two CPU threads, and a tiny copy
of the benchmark whose cells run on the CPU in seconds.

Run from the repository root: ``python -m pytest benchmark/tests``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(2)

# The cells' traffic cut to a size the CPU runs in seconds; every other
# field is the committed mix's.
TINY = {
    "train-1m": {"n_alive": 300, "capacity": 512, "views": 4, "width": 64,
                 "height": 48, "focal": 64.0, "scale_range": [0.02, 0.06],
                 "trace_steps": 2},
}
LOOSE = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2,
         "alive_mismatch": 0.0}


def tiny_copy(dest: Path, limits=None) -> Path:
    """A checkout at ``dest``: ``BENCHMARK.json``, the benchmark's folder
    with tiny traffic and the given limits (``LOOSE`` by default), and
    the program linked in."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(ROOT / "collab_splats_tpu_torch",
               dest / "collab_splats_tpu_torch")
    for mix, cut in TINY.items():
        path = dest / BENCH.name / "traffic" / f"{mix}.json"
        traffic = json.loads(path.read_text())
        traffic.update(cut)
        path.write_text(json.dumps(traffic))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    (dest / BENCH.name / "limits").mkdir(exist_ok=True)
    for w in bench["workloads"]:
        lim = {k: {"limit": v} for k, v in (limits or LOOSE).items()}
        (dest / BENCH.name / "limits" / f"{w['name']}.json").write_text(
            json.dumps(lim))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)


def run_cell(root: Path, cell: str, seed: int = 5, seconds: float = 0.5,
             capsys=None):
    """Run ``cell`` on the CPU in the checkout ``root``; returns (exit
    code, the result line or None)."""
    import run as harness

    code = harness.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", "0"],
                        root=root, device="cpu")
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if code == 0 and out else None
    return code, line

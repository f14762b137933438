"""The control: the plain reference in the precision below the one the
configurations state (TF32 for float32), put in the program's place, has
to come out as not correct under the committed limits, and so has the
half-batch fault; the program has to pass.  Here at a tiny size on the
CPU, where TF32 is emulated by rounding (``reference/precision.py``);
``test_bench_card.py`` runs the same at a cell's own size on a card."""

import argparse
import json
import time

import pytest

from benchlib import spec
from conftest import BENCH, tiny_copy

import run as harness

CALIBRATE = BENCH / "checks" / "calibrate.py"


def readings(root, cell_name, seed, device):
    cal = spec.load_module(CALIBRATE, "bench_calibrate")
    cell = spec.find(root, root / BENCH.name, cell_name)
    loop = spec.loop(cell)
    args = argparse.Namespace(seed=seed, seconds=1.0, trace=0)
    ctx = harness.Context(args, cell, device, time.perf_counter())
    return cal.train_readings(ctx, loop, True), cell.limits


def fails(numbers, limits):
    return [k for k, v in numbers.items() if not v <= limits[k]["limit"]]


@pytest.mark.parametrize("cell", ["train-rade-gs-1m",
                                  "train-rade-features-1m"])
def test_the_control_is_not_correct(tmp_path, cell):
    lim = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    root = tiny_copy(tmp_path, {k: v["limit"] for k, v in lim.items()
                                if not k.startswith("_")})
    out, limits = readings(root, cell, 11, "cpu")
    assert fails(out["program"], limits) == []
    assert fails(out["tf32"], limits)
    assert fails(out["half_batch"], limits)
    assert fails(out["no_cull"], limits) == ["alive_mismatch"]

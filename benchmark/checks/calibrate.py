"""Readings that a cell's limits are set from, on the card, at the cell's
own size, one process for many seeds:

    python3 benchmark/checks/calibrate.py --workload <cell> \
        --seeds 1 2 3 ... [--control-seeds 1 2 3]

From the root of a checkout, on its first card.  Per seed: the
program's numbers over its checked steps against the float32 reference
(the lower reading), and for the control seeds the reference in TF32,
the reference with half of the image left out of the loss and the
reference with the refine's cull left out, each against the float32
reference (the upper readings; a state left unchanged reads 1 on
``change_gap`` and needs no run).  Prints one JSON line per seed.  The
benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import run as harness  # noqa: E402
from benchlib import spec  # noqa: E402
from reference.precision import Products  # noqa: E402


def train_readings(ctx, loop, control: bool):
    tr, prog = loop.setup(ctx)
    del tr
    gc.collect()
    ctx.free()
    n = len(prog[0])
    ref = loop.reference_readings(ctx, Products(False), n)
    out = {"program": loop.numbers(prog, ref),
           "losses": {"program": prog[0], "reference": ref[0]}}
    if control:
        tf32 = loop.reference_readings(ctx, Products(True), n)
        out["tf32"] = loop.numbers(tf32, ref)
        out["losses"]["tf32"] = tf32[0]
        out["half_batch"] = loop.numbers(
            loop.reference_readings(ctx, Products(False), n, half=True),
            ref)
        out["no_cull"] = loop.numbers(
            loop.reference_readings(ctx, Products(False), n, cull=False),
            ref)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args()
    harness.cache_dirs(ROOT)
    cell = spec.find(ROOT, HERE, args.workload)
    loop = spec.loop(cell)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr)
    import collab_splats_tpu_torch  # noqa: F401

    for seed in args.seeds:
        t = time.perf_counter()
        # The checked steps come before any window: no seconds to run.
        run_args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
        ctx = harness.Context(run_args, cell, "cuda:0", time.perf_counter())
        out = train_readings(ctx, loop, seed in args.control_seeds)
        out.update(seed=seed, cell=args.workload,
                   seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        gc.collect()
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())

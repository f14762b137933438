"""Readings that the query cell's limits are set from, on the card, at the
cell's own size, one process for many seeds:

    python3 benchmark/checks/calibrate_query.py --seeds 1 2 3 ... \
        [--control-seeds 1 2 3]

From the root of a checkout, on its first card.  Per seed: the program's
maps of its checked queries against the float32 reference's (the lower
reading), and for the control seeds the reference in TF32 and the
reference scoring each view with the next query's positive, each against
the float32 reference (the upper readings).  Prints one JSON line per
seed.  The benchmark's own runs do not run this.
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

CELL = "query-rade-features-1m"


def readings(ctx, loop, control: bool):
    prog, maps = loop.setup(ctx)
    views = [prog.view(j) for j in range(len(maps))]
    del prog
    gc.collect()
    ctx.free()
    ref = loop.reference_maps(ctx, views, Products(False))
    out = {"program": loop.numbers(maps, ref)}
    if control:
        out["tf32"] = loop.numbers(
            loop.reference_maps(ctx, views, Products(True)), ref)
        out["next_positive"] = loop.numbers(
            loop.reference_maps(ctx, views, Products(False), shift=1), ref)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args()
    harness.cache_dirs(ROOT)
    cell = spec.find(ROOT, HERE, CELL)
    loop = spec.loop(cell)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_query.py: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr)
    import collab_splats_tpu_torch  # noqa: F401

    for seed in args.seeds:
        t = time.perf_counter()
        run_args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
        ctx = harness.Context(run_args, cell, "cuda:0", time.perf_counter())
        out = readings(ctx, loop, seed in args.control_seeds)
        out.update(seed=seed, cell=CELL, seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        gc.collect()
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the densify cell's limits are set from, on the card, at
the cell's own size, one process for many seeds:

    python3 benchmark/checks/calibrate_densify.py --seeds 1 2 3 ... \
        [--control-seeds 1 2 3]

From the root of a checkout, on its first card.  Per seed: the program's
numbers over its checked steps against the float32 reference (the lower
reading), and for the control seeds the reference in TF32 and the
reference whose refine only culls, each against the program, and the
program's refines against the reference's refine that duplicates every
candidate and splits none, on the same inputs (the upper readings; a state left unchanged reads 1 on
``change_gap`` and needs no run).  Prints one JSON line per seed, with each checked refine's counts.
The benchmark's own runs do not run this.
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
from reference import densify as RD  # noqa: E402
from reference.precision import Products  # noqa: E402

CELL = "train-rade-gs-1m-densify"


def readings(ctx, loop, control: bool):
    tr, snapshot, prog, refines = loop.setup(ctx)
    del tr, snapshot
    gc.collect()
    ctx.free()
    n = len(prog[0])
    out = {"program": loop.numbers(ctx, prog, refines, loop.reference_readings(
        ctx, refines, n, Products(False))),
        "refines": [[int(r["result"][k]) for k in ("n_dup", "n_split",
                                                    "n_cull")]
                    for r in refines]}
    if control:
        for name, kw in (("tf32", {"prec": Products(True)}),
                         ("cull_only", {"prec": Products(False),
                                        "densify": False})):
            out[name] = loop.numbers(ctx, prog, refines,
                                     loop.reference_readings(
                                         ctx, refines, n, **kw))
        strat = dict(ctx.config["strategy"], densify_size_thresh=1e9)
        out["refine_duplicates_only"] = sum(
            RD.mismatch(r["result"], RD.refine(
                r["params"], r["alive"], *r["state"], r["noise"], step,
                strat, ctx.config["trainer"]["scene_scale"],
                ctx.traffic["views"]))
            for r, step in zip(refines, loop.refine_steps(ctx, n)))
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
        print("calibrate_densify.py: no CUDA card", file=sys.stderr)
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

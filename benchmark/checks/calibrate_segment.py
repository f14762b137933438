"""Readings that the segmentation cell's limits are set from, on the card,
at the cell's own size, one process for many seeds:

    python3 benchmark/checks/calibrate_segment.py --seeds 1 2 3 ... \
        [--control-seeds 1 2 3]

From the root of a checkout, on its first card.  Per seed: the program's
numbers over its checked frames against the float32 reference (the lower
reading), and for the control seeds the reference in emulated TF32, the
reference with global block ``FAULT_BLOCK`` run in windows and the
reference on a grid moved by half a step, each against the float32
reference (the upper readings).  Prints one JSON line per seed, with the
masks each side kept per frame.  The benchmark's own runs do not run
this.
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

CELL = "segment-sam-vit-h-720p"
FAULT_BLOCK = 7


def readings(ctx, loop, control: bool):
    R = loop.R
    seg, settings, fs, checked = loop.setup(ctx)
    del seg
    gc.collect()
    ctx.free()
    k = ctx.traffic["check_images"]
    t = time.perf_counter()
    ref = loop.reference_images(ctx, fs[:k], R.Precision())
    out = {"program": loop.compare(checked, ref),
           "reference_s": time.perf_counter() - t,
           "kept": [[len(c["kept"]) for c in checked],
                    [len(r.kept) for r in ref]]}
    if control:
        for name, prec, windowed, offset in (
                ("tf32", R.Precision(True), (), 0.5),
                ("global_windowed", R.Precision(), (FAULT_BLOCK,), 0.5),
                ("grid_moved", R.Precision(), (), 0.0)):
            got = loop.reference_images(ctx, fs[:k], prec, windowed, offset)
            out[name] = loop.compare([loop.readings(g) for g in got], ref)
            out["kept_" + name] = [len(g.kept) for g in got]
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
        print("calibrate_segment.py: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr)
    import collab_splats_tpu_torch  # noqa: F401

    for j, seed in enumerate(args.seeds):
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

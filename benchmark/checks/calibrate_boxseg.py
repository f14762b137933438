"""Readings that the box-segmentation cell's limits are set from, on the
card, at the cell's own size, one process for many seeds:

    python3 benchmark/checks/calibrate_boxseg.py --seeds 1 2 3 ... \
        [--control-seeds 1 2 3]

From the root of a checkout, on its first card.  Per seed: the program's
numbers over its checked frames against the float32 references (the lower
reading), and for the control seeds the references in emulated TF32, the
detector's anchors put on the cells' corners instead of their centres,
and the box corners' embeddings swapped, each against the program (the
upper readings).  Prints one JSON line per seed, with the boxes and masks
each side kept per frame.  The benchmark's own runs do not run this.
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

CELL = "segment-yolov8x-sam-vit-h-boxes-720p"
FAULTS = {"tf32": {"tf32": True}, "anchors_on_corners": {"centre": 0.0},
          "corners_swapped": {"corners": (3, 2)}}


def readings(ctx, loop, control: bool):
    seg, fs, checked = loop.setup(ctx)
    del seg
    gc.collect()
    ctx.free()
    k = ctx.traffic["check_images"]
    t = time.perf_counter()
    ref = loop.reference_images(ctx, fs[:k], checked)
    out = {"program": loop.compare(checked, ref),
           "reference_s": time.perf_counter() - t,
           "kept": [[len(c["boxes"]), len(c["kept"])] for c in checked]}
    if control:
        for name, fault in FAULTS.items():
            out[name] = loop.compare(checked, loop.reference_images(
                ctx, fs[:k], checked, **fault))
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
        print("calibrate_boxseg.py: no CUDA card", file=sys.stderr)
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

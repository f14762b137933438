"""Readings that the extraction cell's limits are set from, on the card,
at the cell's own size, one process for many seeds:

    python3 benchmark/checks/calibrate_extract.py --seeds 1 2 3 ... \
        [--control-seeds 1 2 3]

From the root of a checkout, on its first card.  Per seed: the program's
numbers over its checked frames (the maps ``FeatureDatamanager.extract``
kept at set-up) against the float32 reference (the lower reading), and
for the control seeds the reference in emulated TF32 and the reference
with each fault of ``reference/vit.py::tower_map`` (CLIP's last block as
ordinary attention, the positions resized bilinearly, DINOv2's LayerScale
left out, the maps left at their grids' size), each against the float32
reference (the upper readings).  Prints one JSON line per seed.  The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import run as harness  # noqa: E402
from benchlib import spec  # noqa: E402

CELL = "extract-maskclip-dinov2-720p"
FAULTS = ("attention_head", "bilinear_positions", "no_layer_scale",
          "no_final_resize")


def readings(ctx, loop, control: bool):
    R = loop.R
    dm, fs = loop.setup(ctx)
    k = ctx.traffic["check_images"]
    got = loop.slots(dm, k)
    del dm
    loop.free(ctx)
    t = time.perf_counter()
    p = loop.weights(ctx)
    ref = loop.reference_maps(ctx, p, fs[:k], R.Precision())
    out = {"program": loop.compare(got, ref),
           "reference_s": time.perf_counter() - t}
    if control:
        out["tf32"] = loop.compare(loop.reference_maps(
            ctx, p, fs[:k], R.Precision(True)), ref)
        for fault in FAULTS:
            out[fault] = loop.compare(loop.reference_maps(
                ctx, p, fs[:k], R.Precision(), fault), ref)
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
        print("calibrate_extract.py: no CUDA card", file=sys.stderr)
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
        loop.free(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix,
limits and per-layer readers are found by name from ``BENCHMARK.json``
(``benchlib/spec.py``).  The run sets up from the seed, measures for the
given seconds on one card, checks what the timed path produced against
the plain reference (``reference/``), and prints as the last line of its
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``compared``: each number checked beside its limit, which also end
standard error.  Without a card, or with fewer cards than the cell asks
for, it exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Modules that no run may hold once its window has closed, compared by
# their whole top-level name: the JAX package and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "collab_splats_tpu")
HOST_THREADS = 2


def cache_dirs(root: Path) -> None:
    """Every compile cache at a fixed directory inside the checkout (the
    port's own kernels build into ``build/torch_kernels``)."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def few_threads() -> None:
    """One process with few host threads, so that a run's host work does
    not depend on how many cores the machine lends it."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def forbidden_modules() -> list:
    top = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class Context:
    """What a loop gets: the run's arguments, the cell's files, the
    device and the process's start time."""

    def __init__(self, args, cell, device, t0):
        import torch

        self.seed, self.seconds, self.trace = args.seed, args.seconds, \
            bool(args.trace)
        self.config, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.t0 = t0
        self.trainer_seed = None

    def mark(self, phase: str) -> None:
        """Print on standard error the seconds since the process started
        at the end of a set-up phase."""
        print(f"phase {phase} {time.perf_counter() - self.t0:.3f}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, out, compared, args, device_info) -> dict:
    correct = bool(compared) and all(c.ok for c in compared)
    if args.trace:
        values = {}
        for m in cell.per_layer:
            v = m["read"](out["layer"])
            if v is not None:
                values[m["name"]] = (v, m["unit"])
        device_info["busy_s"] = out["layer"]["summary"].busy_s
        device_info["window_s"] = out["layer"]["summary"].window_s
    else:
        values = {m["name"]: (out["e2e"][m["name"]], m["unit"])
                  for m in cell.end_to_end}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": u}
                        for k, (v, u) in values.items()},
            "device": device_info}
    if args.trace:
        from benchlib import trace
        line["breakdown"] = trace.breakdown(out["layer"]["summary"])
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in compared}
    return line


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """Run the cell; ``device`` set (tests: ``"cpu"``) skips the look for
    cards and runs there instead."""
    args = parse(argv)
    bench_dir = Path(__file__).resolve().parent if root == ROOT \
        else root / HERE.name
    cache_dirs(root)
    for p in (str(bench_dir), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from benchlib import spec

    cell = spec.find(root, bench_dir, args.workload)
    few_threads()
    import torch

    torch.set_num_threads(HOST_THREADS)

    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell.chips:
            print(f"run.py: {args.workload} needs {cell.chips} CUDA "
                  f"card(s); found {found}", file=sys.stderr)
            return 2
        device = "cuda:0"
        print(f"card: {card_line()}", file=sys.stderr)
    readers = spec.readers(cell)
    cell = cell._replace(per_layer=[dict(m, read=readers[m["name"]])
                                    for m in cell.per_layer])
    import collab_splats_tpu_torch  # noqa: F401  (the program under test)
    from loops import common

    ctx = Context(args, cell, device, T0)
    ctx.mark("imports")
    out = spec.loop(cell).run(ctx)
    found = forbidden_modules()
    if found:
        print(f"run.py: the process holds {found}", file=sys.stderr)
        return 3
    compared = common.compare(out["numbers"], cell.limits)
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(cell, out, compared, args, info)
    for c in compared:
        print(f"compared {c.name} {c.value!r} limit {c.limit!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)

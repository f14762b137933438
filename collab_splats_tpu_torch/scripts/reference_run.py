"""The reference configuration's run with a kill and a resume, and its
evaluations.

Stages (``--stages``, in this order):

* ``train``: ``scale_train`` with the reference run's flags
  (``--analytic-gt --sh-degree 3 --exact-binning --seed-points 30000
  --capacity 262144 --steps 30000``, every other flag at its default) into
  ``<root>/scale``, in a process of its own; SIGTERM once its history
  holds 14,959 rows (where the reference run was killed);
  a second process resumes from the run directory (its latest checkpoint,
  step 14,000) to the end.  The replayed rows are held against the killed
  run's: every key but ``wall_s``, bit for bit.
* ``mesh``: ``mesh_eval`` on the step-14000 and step-30000 checkpoints.
* ``features``: ``scale_train --features --analytic-gt --sh-degree 3
  --scene-spheres 16 --capacity 65536`` (the reference's rade-features run)
  for 30,000 steps with a checkpoint every 1,000 into
  ``<root>/scale_f``, then ``feature_chain_eval`` on its latest
  checkpoint.

Writes ``<root>/reference_run.json`` (card, stage times, replay check,
summaries, evaluations) and copies the small outputs (that file, the
histories, summaries and logs) to ``--copy-to``.  Needs a CUDA card.

Usage:
    python -m collab_splats_tpu_torch.scripts.reference_run
        [--root runs/reference] [--stages train mesh features]
        [--copy-to out/reference]
"""

from __future__ import annotations

import argparse
import json
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..train.checkpoint import latest_checkpoint

REFERENCE_FLAGS = ["--analytic-gt", "--sh-degree", "3", "--exact-binning",
                   "--seed-points", "30000", "--capacity", "262144",
                   "--steps", "30000"]
FEATURE_FLAGS = ["--features", "--analytic-gt", "--sh-degree", "3",
                 "--scene-spheres", "16", "--capacity", "65536",
                 "--save-every", "1000"]
KILL_AT = 14_959
FEATURE_STEPS = 30_000
MESH_STEPS = (14_000, 30_000)


def module_cmd(name: str, *argv: str) -> List[str]:
    return [sys.executable, "-m", f"collab_splats_tpu_torch.scripts.{name}",
            *argv]


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def rows(path: Path) -> List[Dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln]


def run_logged(cmd: List[str], log: Path) -> float:
    """Run ``cmd`` to its end with its output in ``log``; returns its
    seconds.  A failure raises."""
    t0 = time.perf_counter()
    with open(log, "a") as f:
        subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, check=True)
    return time.perf_counter() - t0


def train_killed(out: Path, kill_at: int, log: Path) -> Dict:
    """The reference run in a process of its own, sent SIGTERM once its
    history holds ``kill_at`` rows (counted as the file grows)."""
    out.mkdir(parents=True, exist_ok=True)
    hist = out / "history.jsonl"
    hist.unlink(missing_ok=True)
    t0 = time.perf_counter()
    with open(log, "a") as f:
        proc = subprocess.Popen(
            module_cmd("scale_train", *REFERENCE_FLAGS, "--out", str(out)),
            stdout=f, stderr=subprocess.STDOUT)
        seen, pos = 0, 0
        try:
            while seen < kill_at:
                if proc.poll() is not None:
                    raise RuntimeError(f"the run ended (code "
                                       f"{proc.returncode}) after {seen} "
                                       f"rows, before the kill at {kill_at}")
                if hist.exists():
                    with open(hist, "rb") as h:
                        h.seek(pos)
                        chunk = h.read()
                    pos += len(chunk)
                    seen += chunk.count(b"\n")
                time.sleep(0.002)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"seconds": time.perf_counter() - t0, "rows_at_kill": seen,
            "returncode": proc.returncode}


def replay_check(out: Path, ckpt_step: int) -> Dict:
    """The resumed run's rows past ``ckpt_step`` against the killed run's,
    every key but ``wall_s``."""
    def strip(r):
        return {k: v for k, v in r.items() if k != "wall_s"}

    killed = {r["step"]: r for r in rows(out / "history_prekill.jsonl")}
    resumed = {r["step"]: r for r in rows(out / "history.jsonl")}
    replayed = sorted(s for s in killed if s > ckpt_step)
    differ = [s for s in replayed
              if s not in resumed or strip(resumed[s]) != strip(killed[s])]
    return {"checkpoint_step": ckpt_step, "replayed_rows": len(replayed),
            "identical_rows": len(replayed) - len(differ),
            "first_replayed": replayed[0] if replayed else None,
            "last_replayed": replayed[-1] if replayed else None,
            "first_difference": differ[0] if differ else None}


def stage_train(root: Path, kill_at: int, report: Dict) -> None:
    out, log = root / "scale", root / "scale.log"
    report["kill"] = train_killed(out, kill_at, log)
    latest = latest_checkpoint(out)
    ckpt_step = int(latest.name.split("-")[1].split(".")[0])
    report["resume_seconds"] = run_logged(
        module_cmd("scale_train", *REFERENCE_FLAGS, "--out", str(out),
                   "--resume", str(out)), log)
    report["replay"] = replay_check(out, ckpt_step)
    report["summary"] = json.loads((out / "summary.json").read_text())


def stage_mesh(root: Path, report: Dict) -> None:
    report["mesh"] = {}
    for step in MESH_STEPS:
        ckpt = root / "scale" / f"step-{step:08d}.ckpt.npz"
        log = root / f"mesh_eval_{step}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            res = subprocess.run(module_cmd("mesh_eval", str(ckpt)),
                                 stdout=subprocess.PIPE, stderr=f,
                                 text=True, check=True)
        payload = json.loads(res.stdout.strip().splitlines()[-1])
        payload["seconds"] = time.perf_counter() - t0
        report["mesh"][str(step)] = payload


def stage_features(root: Path, steps: int, report: Dict) -> None:
    out, log = root / "scale_f", root / "scale_f.log"
    if out.exists():
        shutil.rmtree(out)
    report["features_seconds"] = run_logged(
        module_cmd("scale_train", *FEATURE_FLAGS, "--steps", str(steps),
                   "--out", str(out)), log)
    report["features_summary"] = json.loads(
        (out / "summary.json").read_text())
    t0 = time.perf_counter()
    with open(root / "chain.log", "w") as f:
        res = subprocess.run(module_cmd("feature_chain_eval", str(out)),
                             stdout=subprocess.PIPE, stderr=f, text=True,
                             check=True)
    report["chain"] = json.loads(res.stdout.strip().splitlines()[-1])
    report["chain"]["seconds"] = time.perf_counter() - t0


def copy_small(root: Path, dest: Path) -> None:
    """The report, logs, histories and summaries (no checkpoints)."""
    dest.mkdir(parents=True, exist_ok=True)
    for path in root.rglob("*"):
        if path.is_file() and path.suffix in (".json", ".jsonl", ".log"):
            target = dest / path.relative_to(root)
            target.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(path, target)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m collab_splats_tpu_torch.scripts.reference_run",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path("runs/reference"))
    ap.add_argument("--stages", nargs="+", default=["train", "mesh",
                                                    "features"],
                    choices=["train", "mesh", "features"])
    ap.add_argument("--copy-to", type=Path, default=None)
    args = ap.parse_args(argv)

    args.root.mkdir(parents=True, exist_ok=True)
    report_path = args.root / "reference_run.json"
    report = {"card": card_line()}
    stages = {"train": lambda: stage_train(args.root, KILL_AT, report),
              "mesh": lambda: stage_mesh(args.root, report),
              "features": lambda: stage_features(args.root, FEATURE_STEPS,
                                                 report)}
    try:
        for name in args.stages:
            t0 = time.perf_counter()
            stages[name]()
            report.setdefault("stage_seconds", {})[name] = \
                time.perf_counter() - t0
            report_path.write_text(json.dumps(report, indent=1))
            print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        report_path.write_text(json.dumps(report, indent=1))
        if args.copy_to is not None:
            copy_small(args.root, args.copy_to)
    print(json.dumps(report, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Mesh geometry metrics of an analytic-scene training run.

Counterpart of the JAX package's ``scripts/mesh_eval.py``.  Loads a
``scale_train --analytic-gt`` checkpoint, extracts a TSDF mesh from
rendered depth maps (``meshing/exporters.py::TSDFFusionExporter``, the
reference's default route), and measures its accuracy and completeness
(``utils/metrics.py``) against exact samples of the analytic scene's true
surfaces.  The scene is closed-form, so this isolates the geometry effect
of the depth-normal phase with no scanner noise: run it on the
checkpoint before the phase (step 14000) and on the final one.

Usage:
    python -m collab_splats_tpu_torch.scripts.mesh_eval \
        runs/scale/step-00014000.ckpt.npz [--sh-degree 3]
        [--depth median_depth] [--voxel 0.03] [--out runs/scale/mesh_14000]
        [--cpu]

Prints one JSON line: accuracy (90th-percentile distance to the true
surface, lower is better), completeness (% of the true surface within
0.05, higher is better) and the mesh's size.  An empty mesh exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..core.options import RenderOptions
from ..data import analytic
from ..data.synthetic import orbit_cameras
from ..meshing.exporters import TSDFExporterConfig, TSDFFusionExporter
from ..models import rade_gs
from ..train.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.metrics import calculate_accuracy, calculate_completeness
from .scale_train import N_CAMS


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m collab_splats_tpu_torch.scripts.mesh_eval",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", type=Path)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--depth", default="median_depth",
                    choices=["median_depth", "depth"])
    ap.add_argument("--voxel", type=float, default=0.03)
    ap.add_argument("--max-dim", type=int, default=320)
    ap.add_argument("--n-cams", type=int, default=32,
                    help="integration views (stride over the 64 orbit)")
    ap.add_argument("--gt-samples", type=int, default=200_000)
    ap.add_argument("--min-component", type=float, default=0.002,
                    help="clean_repair component cut as a fraction of "
                         "total faces.  The exporter default (0.05, the "
                         "reference's single-object setting) deletes "
                         "free-floating spheres wholesale in multi-object "
                         "scenes: each sphere is its own component at "
                         "~0.3%% of the faces.")
    ap.add_argument("--threshold", type=float, default=0.05)
    ap.add_argument("--out", type=Path, default=None,
                    help="write mesh.ply/splats.ply here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    return ap


def evaluate_mesh(
    ckpt: Path,
    sh_degree: int = 3,
    width: int = 640,
    height: int = 360,
    depth: str = "median_depth",
    voxel: float = 0.03,
    max_dim: int = 320,
    n_cams: int = 32,
    gt_samples: int = 200_000,
    min_component: float = 0.002,
    threshold: float = 0.05,
    out: Optional[Path] = None,
    device=None,
    stage_times: Optional[Dict] = None,
) -> Dict:
    """The mesh metrics of ``ckpt`` as the JSON payload; ``n_vertices`` is 0
    (and ``accuracy_p90`` None) when no surface crossed the iso level.
    ``stage_times`` collects the exporter's stages and ``"metrics"``."""
    dev = resolve_device(device)
    step, params, alive, _ = load_checkpoint(ckpt, dev)
    print(f"checkpoint step {step}: {int(alive.sum())} alive / "
          f"{alive.shape[0]}", file=sys.stderr, flush=True)
    scene = analytic.default_scene(seed=7)
    cams = orbit_cameras(N_CAMS, radius=3.2, width=width, height=height,
                         focal=0.9 * width, device=dev)
    stride = max(len(cams) // n_cams, 1)
    mcfg = rade_gs.RadeGSConfig(
        sh_degree=sh_degree, background="black",
        render=RenderOptions(rasterize_mode="antialiased"),
        use_depth_normal_loss=False)
    ecfg = TSDFExporterConfig(
        voxel_size=voxel,
        sdf_trunc=3.0 * voxel,
        depth_trunc=12.0,           # scene depths run ~0.5-7.5 world units
        depth_name=depth,
        max_dim=max_dim,
        align_floor=False,          # metrics compare in the GT world frame
        min_component_fraction=min_component,
    )
    t0 = time.time()
    result = TSDFFusionExporter(params, alive, mcfg, ecfg).main(
        cams[::stride], output_dir=out, stage_times=stage_times)
    verts, faces = result["vertices"], result["faces"]
    print(f"mesh: {len(verts)} verts, {len(faces)} faces in "
          f"{time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    if len(verts) == 0:
        return {"ckpt": str(ckpt), "step": step, "n_vertices": 0,
                "accuracy_p90": None, "completeness_pct": 0.0,
                "note": "empty mesh (no surface crossed the TSDF iso level)"}
    t0 = time.perf_counter()
    gt_pts = analytic.sample_gt_surface(scene, gt_samples)
    payload = {
        "ckpt": str(ckpt),
        "step": step,
        "depth_name": depth,
        "voxel_size": voxel,
        "n_vertices": int(len(verts)),
        "n_faces": int(len(faces)),
        "accuracy_p90": calculate_accuracy(verts, gt_pts),
        "completeness_pct": calculate_completeness(verts, gt_pts,
                                                   threshold=threshold),
        "threshold": threshold,
    }
    if stage_times is not None:
        stage_times.setdefault("metrics", []).append(
            time.perf_counter() - t0)
    return payload


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    payload = evaluate_mesh(
        args.ckpt, sh_degree=args.sh_degree, width=args.width,
        height=args.height, depth=args.depth, voxel=args.voxel,
        max_dim=args.max_dim, n_cams=args.n_cams, gt_samples=args.gt_samples,
        min_component=args.min_component, threshold=args.threshold,
        out=args.out, device="cpu" if args.cpu else None)
    print(json.dumps(payload), flush=True)
    return 1 if payload["n_vertices"] == 0 else 0


if __name__ == "__main__":
    sys.exit(main())

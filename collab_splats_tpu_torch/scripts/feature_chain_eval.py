"""The feature chain end to end on a ``scale_train --features`` checkpoint.

Counterpart of the JAX package's ``scripts/feature_chain_eval.py``:

1. load the checkpoint (13-dim latents and the decoder);
2. extract a TSDF mesh with per-vertex latent transfer (the fused
   rasterization feeds the TSDF colours and the k-NN latent transfer;
   reference ``Open3DTSDFFusion.main``);
3. decode the per-vertex latents and score them against a text query of
   the main extractor's text tower (reference ``Splatter.query_mesh``);
4. write mesh.ply and a turbo-coloured mesh_queried.ply, and print one
   JSON line of chain statistics.

Usage:
    python -m collab_splats_tpu_torch.scripts.feature_chain_eval \
        runs/scale_f [--positive sphere] [--negative floor wall]
        [--out runs/scale_f/mesh] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.options import RenderOptions
from ..data.ply import write_ply
from ..data.synthetic import orbit_cameras
from ..features import decoder as decoder_lib
from ..features.extractors import get_extractor
from ..meshing.exporters import TSDFExporterConfig, TSDFFusionExporter
from ..models import rade_features
from ..train.checkpoint import (decoder_arrays, latest_checkpoint,
                                load_checkpoint)
from ..utils.colormaps import turbo
from ..utils.device import resolve_device
from .scale_train import N_CAMS


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m collab_splats_tpu_torch.scripts.feature_chain_eval",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir", type=Path,
                    help="scale_train --features output dir (picks the "
                         "latest checkpoint) or a step-*.ckpt.npz file")
    ap.add_argument("--positive", nargs="+", default=["sphere"])
    ap.add_argument("--negative", nargs="+", default=["floor", "wall"])
    ap.add_argument("--method", default="pairwise",
                    choices=["standard", "pairwise"])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--voxel", type=float, default=0.03)
    ap.add_argument("--max-dim", type=int, default=320)
    ap.add_argument("--n-cams", type=int, default=32)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    return ap


def feature_dims_from_decoder(arrays: Dict[str, np.ndarray]) -> tuple:
    """``feature_dims`` rebuilt from the decoder's head shapes (JAX's
    [hidden, C] layout, the checkpoint's): (name, (C, 1, 1)) per branch,
    so the decode needs no sidecar config."""
    return tuple((k[len("branch_"):-len("_w")], (int(v.shape[1]), 1, 1))
                 for k, v in sorted(arrays.items())
                 if k.startswith("branch_") and k.endswith("_w"))


def run_chain(
    run_dir: Path,
    positive: Sequence[str] = ("sphere",),
    negative: Sequence[str] = ("floor", "wall"),
    method: str = "pairwise",
    width: int = 640,
    height: int = 360,
    voxel: float = 0.03,
    max_dim: int = 320,
    n_cams: int = 32,
    out: Optional[Path] = None,
    device=None,
    text_embeddings: Optional[torch.Tensor] = None,
    stage_times: Optional[Dict] = None,
) -> Dict:
    """The chain on ``run_dir`` (a checkpoint, or a run directory's
    latest); returns the statistics.  ``text_embeddings`` [P + N, C]
    replaces the text tower's embedding of the prompts."""
    dev = resolve_device(device)
    ckpt = run_dir
    if ckpt.is_dir():
        ckpt = latest_checkpoint(ckpt)
        if ckpt is None:
            raise SystemExit(f"no checkpoint under {run_dir}")
    step, params, alive, extras = load_checkpoint(ckpt, dev)
    arrays = decoder_arrays(extras)
    if "distill_features" not in params or not arrays:
        raise SystemExit(f"{ckpt} is not a rade-features checkpoint "
                         "(no distill_features/decoder)")
    latent_dim = params["distill_features"].shape[1]
    print(f"checkpoint step {step}: {int(alive.sum())} alive, latent_dim "
          f"{latent_dim}", file=sys.stderr, flush=True)

    feature_dims = feature_dims_from_decoder(arrays)
    names = [n for n, _ in feature_dims]
    main_name = "clip-vit" if "clip-vit" in names else names[0]
    cfg = rade_features.RadeFeaturesConfig(
        sh_degree=0, background="black",
        render=RenderOptions(rasterize_mode="antialiased"),
        feature_dims=feature_dims, main_feature_name=main_name,
        similarity_method=method)
    decoder = decoder_lib.decoder_from_numpy(arrays, device=dev)

    out_dir = out or (ckpt.parent / f"mesh_{step:06d}")
    cams = orbit_cameras(N_CAMS, radius=3.2, width=width, height=height,
                         focal=0.9 * width, device=dev)
    stride = max(len(cams) // n_cams, 1)
    ecfg = TSDFExporterConfig(voxel_size=voxel, sdf_trunc=3.0 * voxel,
                              depth_trunc=12.0, max_dim=max_dim,
                              align_floor=False)
    result = TSDFFusionExporter(params, alive, cfg, ecfg).main(
        cams[::stride], output_dir=out_dir, stage_times=stage_times)
    verts = result["vertices"]
    vfeats = result.get("features")
    if vfeats is None or vfeats.shape != (len(verts), latent_dim):
        raise AssertionError("latent transfer missing from mesh result")
    print(f"mesh: {len(verts)} verts, {len(result['faces'])} faces, "
          f"per-vertex latents {vfeats.shape}", file=sys.stderr, flush=True)

    # The text query through the decoder and the text tower (its seeded
    # offline fallback when no weights file is found).
    if text_embeddings is None:
        enc = get_extractor(main_name, device=str(dev))
        text_embeddings = enc.encode_text(list(positive) + list(negative))
    with torch.no_grad():
        sims = rade_features.query_vertices(
            decoder, torch.as_tensor(vfeats, device=dev),
            torch.as_tensor(text_embeddings, device=dev), len(positive),
            cfg).cpu().numpy()

    lo, hi = float(sims.min()), float(sims.max())
    norm = (sims - lo) / max(hi - lo, 1e-9)
    queried = out_dir / "mesh_queried.ply"
    write_ply(str(queried), verts,
              colors=turbo(norm)[:, :3].astype(np.float32),
              faces=result["faces"])
    return {
        "ckpt": str(ckpt), "step": step,
        "n_vertices": int(len(verts)), "latent_dim": int(latent_dim),
        "positive": list(positive), "negative": list(negative),
        "similarity_min": lo, "similarity_max": hi,
        "similarity_mean": float(sims.mean()),
        "queried_ply": str(queried),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    stats = run_chain(
        args.run_dir, args.positive, args.negative, args.method, args.width,
        args.height, args.voxel, args.max_dim, args.n_cams, args.out,
        device="cpu" if args.cpu else None)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

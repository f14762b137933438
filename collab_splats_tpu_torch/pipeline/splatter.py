"""End-to-end pipeline orchestrator: data -> SfM -> train -> mesh -> query.

Counterpart of the JAX package's ``pipeline/splatter.py`` (the reference's
``Splatter``), with the same two differences from the reference:

* training runs in-process: the trainer is a library call, so the whole
  pipeline is one Python process;
* SfM stays a subprocess contract: a video or an image directory without
  poses goes through ffmpeg and COLMAP (or hloc) when they are installed,
  and a directory that already holds ``transforms.json`` (for example from
  ``data/synthetic.py::write_synthetic_dataset``) skips straight past
  preprocessing.

Each stage checks for its output and is skipped unless ``overwrite=True``
(``transforms.json``, the run's checkpoints, ``mesh/mesh.ply``).  A run
whose last checkpoint is short of its target resumes from it.  The port's
checkpoints carry the Adam moments and the densification statistics
(``Trainer.save``), so an interrupted run continues bit for bit.

Everything runs on ``device`` (the card unless the caller passes
``device="cpu"``).  Initialisation draws from ``torch.Generator(seed)``,
not from ``jax.random``.  Images are read and written through the port's
PNG codec, and query colours come from its own turbo table, so a run needs
neither PIL nor matplotlib.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Union

import numpy as np
import torch

from ..data.datamanager import FullImageDatamanager
from ..features import decoder as decoder_lib
from ..models import rade_features
from ..models.gaussians import init_from_points
from ..train import checkpoint as ckpt_lib
from ..train.trainer import CAMERA_PARAM_GROUPS, Trainer
from ..utils.device import resolve_device
from .methods import METHODS, get_method

DEFAULT_TIMEOUT = 3600
VIDEO_EXTENSIONS = {".mp4", ".mov", ".avi", ".mkv", ".webm"}


def _tuplify(x):
    """JSON round-trips tuples as lists; the frozen configs need tuples
    back."""
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuplify(v) for k, v in x.items()}
    return x


class ValidationError(Exception):
    """Raised when the pipeline configuration is invalid."""


class Splatter:
    """The pipeline over one input (``file_path``) with one ``method``.

    ``load_model`` returns (step, params, alive, method spec, model config,
    decoder): the port keeps the rade-features decoder out of the parameter
    dict, so it is the sixth entry (None for the other methods)."""

    SPLATTING_METHODS: Set[str] = set(METHODS)

    def __init__(self, config: Dict[str, Any], device=None):
        self.config = self.validate_config(dict(config))
        self.device = resolve_device(device)
        self._preprocess_config: Dict[str, Any] = {}
        self._training_config: Dict[str, Any] = {}
        self._meshing_config: Dict[str, Any] = {}
        self._loaded = None

    # ------------------------------------------------------------ validate
    @classmethod
    def validate_config(cls, config: Dict[str, Any]) -> Dict[str, Any]:
        required = {"file_path", "method"}
        missing = required - set(config)
        if missing:
            raise ValidationError(f"Missing required fields: {missing}")
        if config["method"] not in cls.SPLATTING_METHODS:
            raise ValidationError(
                f"Invalid method '{config['method']}'. "
                f"Valid methods are: {sorted(cls.SPLATTING_METHODS)}")
        file_path = Path(config["file_path"])
        if not file_path.exists():
            raise ValidationError(f"File not found: {file_path}")
        config["file_path"] = file_path
        if config.get("output_path") is None:
            config["output_path"] = (
                file_path.parent.parent / "environment" / file_path.stem)
        config["output_path"] = Path(config["output_path"])
        config.setdefault("min_frames", 300)
        config.setdefault("frame_proportion", 0.25)
        return config

    @classmethod
    def available_methods(cls) -> None:
        print("Available methods:")
        print("  ", sorted(cls.SPLATTING_METHODS))

    @classmethod
    def from_config_file(
        cls,
        dataset: Optional[str],
        config_dir: Union[str, Path],
        overrides: Optional[Dict[str, Any]] = None,
        device=None,
    ) -> "Splatter":
        from .config import ConfigLoader

        config = ConfigLoader(config_dir).load(dataset=dataset,
                                               overrides=overrides)
        inst = cls({
            k: config[k]
            for k in ("file_path", "method", "output_path", "min_frames",
                      "frame_proportion")
            if k in config
        }, device=device)
        inst._preprocess_config = config.get("preprocess", {}) or {}
        inst._training_config = config.get("training", {}) or {}
        inst._meshing_config = config.get("meshing", {}) or {}
        return inst

    # ------------------------------------------------------------ helpers
    @property
    def preproc_dir(self) -> Path:
        return self.config["output_path"] / "preproc"

    @property
    def model_dir(self) -> Path:
        return self.config["output_path"] / "model" / self.config["method"]

    @property
    def mesh_dir(self) -> Path:
        return self.config["output_path"] / "mesh"

    def _runs(self) -> List[Path]:
        if not self.model_dir.exists():
            return []
        return sorted(
            d for d in self.model_dir.iterdir()
            if d.is_dir() and ckpt_lib.latest_checkpoint(d) is not None)

    def _datamanager(self, downscale_factor: int = 1) -> FullImageDatamanager:
        return FullImageDatamanager.from_transforms_json(
            self.preproc_dir / "transforms.json",
            downscale_factor=downscale_factor, device=self.device)

    def _train_cameras(self):
        """The training cameras of ``transforms.json`` (no image read)."""
        from ..data.dataparser import parse_transforms_json

        return parse_transforms_json(self.preproc_dir / "transforms.json",
                                     device=self.device).train_cameras

    # ------------------------------------------------------------ pipeline
    def run_pipeline(self, overwrite: bool = False) -> None:
        print(f"Running {self.config['method']} pipeline on "
              f"{self.config['file_path'].name}")
        print("[1/3] Preprocessing...")
        self.preprocess(overwrite=overwrite, **self._preprocess_config)
        print("[2/3] Training...")
        self.train(overwrite=overwrite, **self._training_config)
        print("[3/3] Meshing...")
        mesh_cfg = dict(self._meshing_config)
        mesher_type = mesh_cfg.pop("mesher_type", "TSDFFusion")
        self.mesh(overwrite=overwrite, mesher_type=mesher_type, **mesh_cfg)
        print("Pipeline complete.")

    # ---------------------------------------------------------- preprocess
    def preprocess(self, overwrite: bool = False, sfm_tool: str = "colmap",
                   **_: Any) -> Path:
        """Produce ``preproc/transforms.json`` (resume point)."""
        out = self.preproc_dir
        if (out / "transforms.json").exists() and not overwrite:
            print(f"  transforms.json exists, skipping ({out})")
            return out

        src = self.config["file_path"]
        if src.is_dir() and (src / "transforms.json").exists():
            out.mkdir(parents=True, exist_ok=True)
            for item in src.iterdir():
                dst = out / item.name
                if dst.exists():
                    continue
                if item.is_dir():
                    # Copy through a temporary directory and a rename, so
                    # an interrupted copy leaves no partial directory that
                    # a later resume would skip.
                    tmp = out / (item.name + ".tmp_copy")
                    if tmp.exists():
                        shutil.rmtree(tmp)
                    shutil.copytree(item, tmp)
                    tmp.rename(dst)
                else:
                    shutil.copy2(item, dst)
            return out

        if src.suffix.lower() in VIDEO_EXTENSIONS:
            frames_dir = out / "images"
            frames_dir.mkdir(parents=True, exist_ok=True)
            n_frames = self._count_frames(src)
            target = max(int(n_frames * self.config["frame_proportion"]),
                         min(self.config["min_frames"], n_frames))
            step = max(n_frames // max(target, 1), 1)
            subprocess.run(
                ["ffmpeg", "-y", "-i", str(src),
                 "-vf", f"select=not(mod(n\\,{step}))", "-vsync", "vfr",
                 str(frames_dir / "frame_%05d.png")],
                check=True, timeout=DEFAULT_TIMEOUT, capture_output=True)
            self._run_sfm(frames_dir, out, sfm_tool, ordered=True)
            return out
        if src.is_dir():
            # Paths containing "360" are equirectangular: each panorama is
            # cropped into 14 perspective views before SfM.
            if "360" in str(src):
                from .equirect import crop_equirect_dir

                crops = out / "images"
                if crop_equirect_dir(src, crops) == 0:
                    raise ValidationError(f"no panorama images in {src}")
                # Interleaved per-panorama crops are not temporally
                # adjacent on disk: exhaustive matching.
                self._run_sfm(crops, out, sfm_tool, ordered=False)
                return out
            self._run_sfm(src, out, sfm_tool, ordered=False)
            return out
        raise ValidationError(f"Unsupported input: {src}")

    @staticmethod
    def _count_frames(video: Path) -> int:
        try:
            import cv2

            cap = cv2.VideoCapture(str(video))
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            return n
        except ImportError:
            out = subprocess.run(
                ["ffprobe", "-v", "error", "-count_frames",
                 "-select_streams", "v:0", "-show_entries",
                 "stream=nb_read_frames", "-of", "csv=p=0", str(video)],
                capture_output=True, text=True, timeout=DEFAULT_TIMEOUT)
            return int(out.stdout.strip() or 0)

    @staticmethod
    def _run_sfm(images_dir: Path, out: Path, sfm_tool: str,
                 ordered: bool = False) -> None:
        """External SfM -> transforms.json: hloc when asked for and
        importable, else COLMAP, with a clear error when neither is
        installed.  Temporally ordered frames (a video) match sequentially,
        other image sets exhaustively."""
        from . import colmap, hloc

        matcher = "sequential" if ordered else "exhaustive"
        if sfm_tool in ("exhaustive", "sequential"):
            matcher = sfm_tool
        if sfm_tool == "hloc" and hloc.hloc_available():
            hloc.run_hloc_sfm(images_dir, out, matcher=matcher)
            return
        if not colmap.colmap_available():
            raise ValidationError(
                "No SfM tool available (hloc not importable, COLMAP not on "
                "PATH): SfM preprocessing needs an external tool (same "
                "contract as the reference's ns-process-data).  Provide a "
                "dataset directory containing transforms.json to skip SfM.")
        colmap.run_colmap_sfm(images_dir, out, matcher=matcher)

    # ------------------------------------------------------------ training
    def train(
        self,
        overwrite: bool = False,
        max_iterations: Optional[int] = None,
        downscale_factor: int = 1,
        capacity: Optional[int] = None,
        seed: int = 42,
        num_downscales: Optional[int] = None,
        resolution_schedule: Optional[int] = None,
        **method_kwargs: Any,
    ):
        """Train the selected method in-process.

        A completed run is skipped; an interrupted run (latest checkpoint
        step < its target) is restored and continued to its target.
        """
        resume_run = None
        if self._runs() and not overwrite:
            last = self._runs()[-1]
            ck = ckpt_lib.latest_checkpoint(last)
            saved_step = int(ck.name.split("-")[1].split(".")[0])
            target = max_iterations
            if target is None:
                try:
                    with open(last / "config.json") as f:
                        target = json.load(f).get("max_iterations")
                except OSError:
                    target = None
            if target is not None and saved_step < target:
                print(f"  resuming interrupted run at step {saved_step} "
                      f"({last})")
                resume_run = last
                # Continue toward the run's original target.
                max_iterations = target
            else:
                print(f"  checkpoints exist, skipping ({self.model_dir})")
                return last

        spec = get_method(self.config["method"])
        dm = self._datamanager(downscale_factor)

        features = None
        # Feature-only keys ride in every config: pop them for all methods.
        feature_kw = {k: method_kwargs.pop(k) for k in
                      ("feature_type", "extractors", "final_resolution")
                      if k in method_kwargs}
        if spec.has_features:
            from ..data.dataparser import parse_transforms_json
            from ..features.datamanager import (FeatureDatamanager,
                                                FeatureDatamanagerConfig)

            fcfg = FeatureDatamanagerConfig(
                cache_dir=str(self.config["output_path"] / "features"),
                **feature_kw)
            scene_names = [str(p) for p in parse_transforms_json(
                self.preproc_dir / "transforms.json", downscale_factor,
                device=self.device).train_image_paths]
            dm = FeatureDatamanager(dm, fcfg, image_names=scene_names,
                                    device=self.device)
            features = dm.train_features
            method_kwargs["feature_dims"] = tuple(
                sorted(dm.feature_dims.items()))
            method_kwargs["main_feature_name"] = \
                dm.feature_config.feature_type

        tconf = spec.make_trainer_config(**method_kwargs)
        if max_iterations:
            tconf = dataclasses.replace(tconf, max_iterations=max_iterations)
        if num_downscales is not None:
            tconf = dataclasses.replace(tconf, num_downscales=num_downscales)
        if resolution_schedule is not None:
            tconf = dataclasses.replace(
                tconf, resolution_schedule=resolution_schedule)
        tconf = dataclasses.replace(tconf, scene_scale=dm.scene_scale)

        gen = torch.Generator().manual_seed(seed)
        if dm.points is not None and len(dm.points) >= 8:
            pts = np.asarray(dm.points, np.float32)
            cols = np.asarray(
                dm.point_colors if dm.point_colors is not None
                else np.full((len(dm.points), 3), 0.5), np.float32)
        else:
            pts = (torch.rand((5000, 3), generator=gen) * 2.0 - 1.0).numpy()
            cols = np.full((5000, 3), 0.5, np.float32)
        cap = capacity or max(4 * pts.shape[0], 1 << 12)
        params, alive = init_from_points(
            pts, cols, gen, sh_degree=tconf.model.sh_degree, capacity=cap,
            device=self.device)
        decoder = None
        if spec.has_features:
            params, decoder = rade_features.init_feature_params(
                params, tconf.model,
                generator=torch.Generator().manual_seed(seed + 1))

        run_dir = resume_run or self.model_dir / \
            datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
        run_dir.mkdir(parents=True, exist_ok=True)
        with open(run_dir / "config.json", "w") as f:
            json.dump({"method": self.config["method"],
                       "method_kwargs": method_kwargs,
                       "max_iterations": tconf.max_iterations},
                      f, indent=2, default=list)

        def save(tr: Trainer):
            tr.save(run_dir, metadata={"method": self.config["method"]})

        trainer = Trainer(
            tconf, dm.train_cameras,
            [im.astype(np.float32) / 255.0 for im in dm.train_images],
            params, alive, groups=spec.groups, checkpoint_fn=save,
            features=features, decoder=decoder, device=self.device)
        if resume_run is not None:
            trainer.restore(ckpt_lib.latest_checkpoint(resume_run))
        remaining = max(tconf.max_iterations - trainer.step, 0)
        trainer.train(
            num_steps=remaining, eval_cameras=dm.eval_cameras,
            eval_images=[im.astype(np.float32) / 255.0
                         for im in dm.eval_images])
        save(trainer)
        self._loaded = (trainer.step,
                        {k: v.detach() for k, v in trainer.params.items()},
                        trainer.alive, spec, tconf.model, trainer.decoder)
        return run_dir

    # -------------------------------------------------------------- loading
    def _select_run(self, runs) -> Path:
        """Pick among timestamped runs: with one run, or with no TTY, the
        most recent; interactively, the runs are listed and the user picks
        by index, Enter meaning the most recent."""
        import sys

        if len(runs) == 1 or not sys.stdin.isatty():
            return runs[-1]
        print(f"Found {len(runs)} training runs:")
        for i, r in enumerate(runs):
            print(f"[{i}] {r.name}")
        while True:
            sel = input(
                "\nSelect run number (or press Enter for most recent): "
            ).strip()
            if sel == "":
                return runs[-1]
            try:
                idx = int(sel)
            except ValueError:
                print("Please enter a valid number")
                continue
            if 0 <= idx < len(runs):
                return runs[idx]
            print(f"Please enter a number between 0 and {len(runs) - 1}")

    def load_model(self, run: Optional[Path] = None):
        """(step, params, alive, spec, model config, decoder) of the latest
        checkpoint of ``run`` (by default the selected run), on the
        Splatter's device; the options' per-camera parameters are left
        out."""
        if self._loaded is not None and run is None:
            return self._loaded
        runs = self._runs()
        if not runs:
            raise ValidationError(f"No trained runs under {self.model_dir}")
        run = run or self._select_run(runs)
        path = ckpt_lib.latest_checkpoint(run)
        step, params, alive, extras = ckpt_lib.load_checkpoint(
            path, self.device)
        params = {k: v for k, v in params.items()
                  if k not in CAMERA_PARAM_GROUPS}
        arrays = ckpt_lib.decoder_arrays(extras)
        decoder = decoder_lib.decoder_from_numpy(arrays, self.device) \
            if arrays else None
        spec = get_method(self.config["method"])
        try:
            with open(run / "config.json") as f:
                kwargs = _tuplify(json.load(f).get("method_kwargs", {}))
        except (OSError, json.JSONDecodeError):
            kwargs = {}
        tconf = spec.make_trainer_config(**kwargs)
        self._loaded = (step, params, alive.to(torch.bool), spec,
                        tconf.model, decoder)
        return self._loaded

    # -------------------------------------------------------------- meshing
    def mesh(self, overwrite: bool = False, mesher_type: str = "TSDFFusion",
             **mesher_kwargs: Any) -> Dict[str, np.ndarray]:
        from ..meshing.exporters import (DepthAndNormalMapsPoissonExporter,
                                         GaussiansToPoissonExporter,
                                         LevelSetExtractor,
                                         TSDFExporterConfig,
                                         TSDFFusionExporter)

        out = self.mesh_dir
        if (out / "mesh.ply").exists() and not overwrite:
            print(f"  mesh exists, skipping ({out})")
            from ..data.ply import read_ply

            # The keys of a fresh export ("vertices", "faces"), not
            # read_ply's "points": a re-run returns the same keys.
            ply = read_ply(str(out / "mesh.ply"))
            result = {"vertices": ply["points"], "faces": ply.get("faces")}
            if "colors" in ply:
                result["colors"] = ply["colors"]
            return result

        _, params, alive, _, model_cfg, _ = self.load_model()
        if mesher_type in ("TSDFFusion", "Open3DTSDFFusion"):
            known = {f.name for f in dataclasses.fields(TSDFExporterConfig)}
            cfg = TSDFExporterConfig(**{
                k: v for k, v in mesher_kwargs.items() if k in known})
            return TSDFFusionExporter(params, alive, model_cfg, cfg).main(
                self._train_cameras(), output_dir=out)
        if mesher_type in ("GaussiansToPoisson",):
            return GaussiansToPoissonExporter(params, alive, model_cfg).main(
                out)
        if mesher_type in ("LevelSetExtractor", "MarchingCubesMesh"):
            known = {"level", "resolution"}
            return LevelSetExtractor(
                params, alive, model_cfg,
                **{k: v for k, v in mesher_kwargs.items() if k in known},
            ).main(output_dir=out)
        if mesher_type in ("DepthAndNormalMapsPoisson",):
            known = {"depth_name", "alpha_thresh", "stride"}
            return DepthAndNormalMapsPoissonExporter(
                params, alive, model_cfg,
                **{k: v for k, v in mesher_kwargs.items() if k in known},
            ).main(self._train_cameras(), output_dir=out)
        raise ValidationError(f"Unknown mesher_type: {mesher_type}")

    # ------------------------------------------------------------ mesh utils
    def load_aligned_cameras(self):
        """Training cameras moved by the mesh's floor alignment: poses in
        the same z-up, floor-at-zero frame as the exported mesh."""
        feats = self.mesh_dir / "mesh_features.npz"
        T = np.eye(4)
        if feats.exists():
            with np.load(feats) as data:
                if "floor_transform" in data:
                    T = data["floor_transform"]
        Tt = torch.as_tensor(np.asarray(T, np.float32), device=self.device)
        out = []
        for cam in self._train_cameras():
            c2w = cam.c2w
            new = torch.eye(4, dtype=torch.float32, device=self.device)
            new[:3, :3] = Tt[:3, :3] @ c2w[:3, :3]
            new[:3, 3] = Tt[:3, :3] @ c2w[:3, 3] + Tt[:3, 3]
            out.append(dataclasses.replace(cam, c2w=new))
        return out

    def plot_mesh(self, output_fn=None, width: int = 800, height: int = 600):
        """Render the extracted mesh to an image from an orbit camera (a
        z-buffer painter on the host); ``output_fn`` saves it as PNG."""
        from ..core.cameras import make_camera
        from ..data.ply import read_ply
        from ..data.png import write_png
        from ..data.synthetic import look_at_c2w
        from ..utils.visualization import render_mesh

        mesh = read_ply(str(self.mesh_dir / "mesh.ply"))
        pts = mesh["points"]
        center = pts.mean(axis=0)
        radius = 2.5 * float(np.abs(pts - center).max())
        eye = center + radius * np.array([0.6, 0.6, 0.5])
        cam = make_camera(
            0.9 * max(width, height), 0.9 * max(width, height),
            width / 2, height / 2, width, height, look_at_c2w(eye, center),
            device="cpu")
        img = render_mesh(
            pts, mesh.get("faces", np.zeros((0, 3), np.int32)),
            mesh.get("colors", np.full_like(pts, 0.7)), cam)
        if output_fn is not None:
            write_png(output_fn, (img * 255).astype(np.uint8))
        return img

    # --------------------------------------------------------------- viewer
    def viewer(self, port: int = 7007, blocking: bool = True,
               width: int = 640, height: int = 480):
        """Serve the interactive splat viewer for the trained model (the
        reference's ``ns-viewer``)."""
        from .viewer import SplatViewer

        _, params, alive, _, model_cfg, _ = self.load_model()
        v = SplatViewer(params, alive, model_cfg, width=width, height=height,
                        device=self.device)
        v.serve(port=port, blocking=blocking)
        return v

    # -------------------------------------------------------------- querying
    def query_mesh(
        self,
        positive: List[str],
        negative: Optional[List[str]] = None,
        method: str = "pairwise",
        output_fn: Optional[Path] = None,
    ) -> np.ndarray:
        """Per-vertex text-query similarity over the extracted mesh; with
        ``output_fn``, the mesh coloured by turbo(similarity) as PLY."""
        negative = negative or ["object"]
        feats_file = self.mesh_dir / "mesh_features.npz"
        if not feats_file.exists():
            raise ValidationError("Run mesh() first: no mesh_features.npz")
        with np.load(feats_file) as data:
            vertex_latents = torch.as_tensor(data["features"],
                                             device=self.device)

        _, _, _, _, model_cfg, decoder = self.load_model()
        if decoder is None:
            raise ValidationError(
                "query_mesh needs a feature method (rade-features)")
        from ..features.extractors import get_extractor

        enc = get_extractor(model_cfg.main_feature_name, device=self.device)
        emb = torch.as_tensor(enc.encode_text(list(positive) + list(negative)),
                              device=self.device)
        cfg = dataclasses.replace(model_cfg, similarity_method=method)
        with torch.no_grad():
            sims = rade_features.query_vertices(
                decoder, vertex_latents, emb, len(positive), cfg)
        sims = sims.cpu().numpy()
        if output_fn is not None:
            from ..data.ply import read_ply, write_ply
            from ..utils.colormaps import turbo

            mesh = read_ply(str(self.mesh_dir / "mesh.ply"))
            colors = turbo(np.clip(sims, 0, 1))[:, :3]
            write_ply(str(output_fn), mesh["points"], colors=colors,
                      faces=mesh.get("faces"))
        return sims

"""The port stands alone: no JAX, nothing of the JAX package or of
``scripts/``, the card by default."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import collab_splats_tpu_torch
from collab_splats_tpu_torch.core.cameras import camera_from_numpy, make_camera
from collab_splats_tpu_torch.data.synthetic import (
    flat_disk_gaussian,
    orbit_cameras,
    random_gaussian_params,
)
from collab_splats_tpu_torch.meshing import tsdf
from collab_splats_tpu_torch.meshing.poisson import poisson_reconstruct
from collab_splats_tpu_torch.models.gaussians import (
    init_from_points,
    params_from_numpy,
)
from collab_splats_tpu_torch.train import strategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(collab_splats_tpu_torch.__file__).parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "collab_splats_tpu",
             # the converters under scripts/, which only the tests import
             "scripts", "convert_weights", "convert_sam", "convert_yolo"}


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="collab_splats_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = port_modules()
    assert "collab_splats_tpu_torch.ops.cuda.batched" in mods
    for m in ("ops.cuda.segsum_kernel", "ops.cuda.composite",
              "train.losses", "train.optim", "train.strategy",
              "train.trainer", "meshing.marching", "meshing._native",
              "meshing.repair", "meshing.align", "meshing.tsdf",
              "meshing.transfer", "meshing.poisson", "meshing.exporters",
              "utils.metrics", "features.decoder", "features.weights",
              "features.clip_tokenizer", "features.vit",
              "features.extractors", "features.datamanager", "features.sam",
              "features.sam_predictor", "features.yolo",
              "features.segmentation", "features.grouping",
              "train.camera_opt", "train.bilateral", "utils.writers",
              "utils.lpips", "utils.pointcloud", "utils.visualization",
              "utils.colormaps", "data.png", "pipeline.config",
              "pipeline.colmap", "pipeline.hloc", "pipeline.equirect",
              "pipeline.viewer", "pipeline.splatter", "pipeline.cli",
              "parallel.mesh", "parallel.collectives", "parallel.tiles",
              "parallel.train", "core.golden", "data.analytic",
              "utils.profiling", "scripts.scale_train", "scripts.mesh_eval",
              "scripts.feature_chain_eval", "scripts.reference_run"):
        assert f"collab_splats_tpu_torch.{m}" in mods
    code = "\n".join(
        ["import sys"]
        + [f"sys.modules[{m!r}] = None" for m in sorted(FORBIDDEN)]
        + [f"import {m}" for m in mods]
        + ["assert not any(m.split('.')[0] in "
           f"{sorted(FORBIDDEN)!r} for m in sys.modules if sys.modules[m])"]
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("entry", [
    lambda: random_gaussian_params(torch.Generator(), 4),
    lambda: orbit_cameras(1),
    lambda: make_camera(100.0, 100.0, 32.0, 32.0, 64, 64, np.eye(4)),
    lambda: camera_from_numpy(np.eye(3), np.eye(4), 64, 64),
    lambda: params_from_numpy({
        "means": np.zeros((2, 3), np.float32),
        "scales": np.zeros((2, 3), np.float32),
        "quats": np.zeros((2, 4), np.float32),
        "opacities": np.zeros((2, 1), np.float32),
        "features_dc": np.zeros((2, 3), np.float32),
        "features_rest": np.zeros((2, 0, 3), np.float32),
    }),
    lambda: init_from_points(np.zeros((4, 3), np.float32),
                             np.zeros((4, 3), np.float32), None),
    lambda: strategy.init_state(4),
    lambda: Trainer(TrainerConfig(), [], [], {}, torch.zeros(0, dtype=bool)),
    lambda: tsdf.create_volume(tsdf.TSDFConfig(dims=(4, 4, 4))),
    lambda: tsdf.volume_from_bounds(np.zeros(3), np.ones(3), 0.5),
    lambda: flat_disk_gaussian(),
    lambda: poisson_reconstruct(np.eye(3, dtype=np.float32),
                                np.eye(3, dtype=np.float32), grid_res=8),
], ids=["random_gaussian_params", "orbit_cameras", "make_camera",
        "camera_from_numpy", "params_from_numpy", "init_from_points",
        "strategy.init_state", "Trainer", "tsdf.create_volume",
        "tsdf.volume_from_bounds", "flat_disk_gaussian",
        "poisson_reconstruct"])
def test_card_default_raises_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("entry", [
    "init_camera_opt", "init_bilateral_grids", "lpips", "SplatViewer",
    "Splatter", "write_synthetic_dataset"])
def test_pipeline_entries_need_a_card_or_the_cpu(monkeypatch, tmp_path,
                                                 entry):
    """This slice's entry points run on the card unless asked for the CPU
    (LPIPS is given a weights file, so it reaches the device choice)."""
    from collab_splats_tpu_torch.data.synthetic import \
        write_synthetic_dataset
    from collab_splats_tpu_torch.pipeline.splatter import Splatter
    from collab_splats_tpu_torch.pipeline.viewer import SplatViewer
    from collab_splats_tpu_torch.train.bilateral import init_bilateral_grids
    from collab_splats_tpu_torch.train.camera_opt import init_camera_opt
    from collab_splats_tpu_torch.utils import lpips

    np.savez(tmp_path / "vgg16_lpips.npz", x=np.zeros(1, np.float32))
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(tmp_path))
    params = random_gaussian_params(torch.Generator(), 4, device="cpu")
    make = {
        "init_camera_opt": lambda **kw: init_camera_opt(2, **kw),
        "init_bilateral_grids": lambda **kw: init_bilateral_grids(1, **kw),
        "SplatViewer": lambda **kw: SplatViewer(
            params, torch.ones(4, dtype=torch.bool), **kw),
        "Splatter": lambda **kw: Splatter(
            {"file_path": str(tmp_path), "method": "rade-gs"}, **kw),
        "write_synthetic_dataset": lambda **kw: write_synthetic_dataset(
            tmp_path / "d", n_cams=1, n_gaussians=4, width=16, height=16,
            **kw),
    }.get(entry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "lpips":
        # Numpy images: the device is the caller's choice, the card by
        # default.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lpips.lpips(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)))
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    make(device="cpu")


@pytest.mark.parametrize("entry", [
    "DINOv2Extractor", "MaskCLIPExtractor", "SamBackend",
    "ObjectAwareDetector", "FeatureDatamanager"])
def test_feature_entries_need_a_card_or_the_cpu(monkeypatch, tmp_path,
                                                entry):
    """The towers' entry points run on the card unless asked for the CPU;
    SAM and the detector are given a weights file, so they reach the
    device choice."""
    from collab_splats_tpu_torch.data.datamanager import FullImageDatamanager
    from collab_splats_tpu_torch.features import (datamanager, extractors,
                                                  sam_predictor, yolo)

    npz = tmp_path / "w.npz"
    np.savez(npz, **{"prompt.pe_gauss": np.zeros((2, 128), np.float32)})
    base = FullImageDatamanager([None], [], [np.zeros((8, 8, 3), np.uint8)],
                                [])
    cfg = datamanager.FeatureDatamanagerConfig(
        feature_type="hash-proj", extractors=("hash-proj",))
    make = {
        "DINOv2Extractor": lambda **kw: extractors.DINOv2Extractor(
            offline_blocks=1, **kw),
        "MaskCLIPExtractor": lambda **kw: extractors.MaskCLIPExtractor(
            offline_blocks=1, offline_width=64, **kw),
        "SamBackend": lambda **kw: sam_predictor.SamBackend(str(npz), **kw),
        "ObjectAwareDetector": lambda **kw: yolo.ObjectAwareDetector(
            str(npz), **kw),
        "FeatureDatamanager": lambda **kw: datamanager.FeatureDatamanager(
            base, cfg, **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("entry", [
    "make_mesh", "make_hybrid_mesh", "initialize_distributed"])
def test_parallel_entries_need_a_card_or_the_cpu(monkeypatch, entry):
    """The multi-device entry points take the card (NCCL) unless asked for
    the CPU (gloo)."""
    from collab_splats_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pmesh, entry)()
    if entry == "initialize_distributed":
        assert pmesh.initialize_distributed(device_type="cpu") == 0
    else:
        with pytest.raises(RuntimeError, match="no process group"):
            getattr(pmesh, entry)(device_type="cpu")

"""COLMAP SfM runner: images dir -> poses -> ``transforms.json``.

Counterpart of the JAX package's ``pipeline/colmap.py``, an own copy; it
replaces the reference's ``ns-process-data`` shell-out.  Pipeline:

    colmap feature_extractor -> {exhaustive|sequential}_matcher ->
    mapper -> model_converter(TXT) -> parse -> transforms.json (+ sparse
    points ply for Gaussian seeding, written by the port's
    ``data/ply.py``)

Pose conversion follows nerfstudio's ``colmap_to_json`` exactly (w2c quat
-> c2w, OpenCV->OpenGL camera flip, world-axis permutation), so datasets
preprocessed here are interchangeable with the reference's.  Everything is
gated on ``shutil.which("colmap")`` with a clear error (provide
``transforms.json`` directly when no SfM binary exists).
"""


from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_TIMEOUT = 7200


class ColmapError(RuntimeError):
    pass


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def _run(args: List[str], cwd: Optional[Path] = None) -> None:
    res = subprocess.run(
        args, cwd=cwd, capture_output=True, text=True, timeout=DEFAULT_TIMEOUT
    )
    if res.returncode != 0:
        raise ColmapError(
            f"{' '.join(args[:2])} failed (rc={res.returncode}):\n"
            f"{res.stderr[-2000:]}"
        )


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def parse_cameras_txt(path: Path) -> Dict[int, Dict]:
    """COLMAP cameras.txt -> {camera_id: intrinsics dict}."""
    cams: Dict[int, Dict] = {}
    for line in path.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        w, h = int(parts[2]), int(parts[3])
        p = [float(x) for x in parts[4:]]
        if model == "SIMPLE_PINHOLE":
            fl_x = fl_y = p[0]
            cx, cy = p[1], p[2]
            dist = {}
        elif model == "PINHOLE":
            fl_x, fl_y, cx, cy = p[:4]
            dist = {}
        elif model == "SIMPLE_RADIAL":
            fl_x = fl_y = p[0]
            cx, cy = p[1], p[2]
            dist = {"k1": p[3]}
        elif model == "RADIAL":
            fl_x = fl_y = p[0]
            cx, cy = p[1], p[2]
            dist = {"k1": p[3], "k2": p[4]}
        elif model == "OPENCV":
            fl_x, fl_y, cx, cy = p[:4]
            dist = dict(zip(("k1", "k2", "p1", "p2"), p[4:8]))
        else:
            raise ColmapError(f"unsupported COLMAP camera model {model}")
        cams[cam_id] = {
            "w": w, "h": h, "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
            **dist,
        }
    return cams


def parse_images_txt(path: Path) -> List[Dict]:
    """COLMAP images.txt -> [{name, qvec, tvec, camera_id}] (pose lines
    only; the 2D-point lines between them are skipped)."""
    out: List[Dict] = []
    # Keep blank lines: each image line is followed by its (possibly empty)
    # 2D-points line, so pairing must not collapse empties.
    lines = [
        ln for ln in path.read_text().splitlines()
        if not ln.startswith("#")
    ]
    while lines and not lines[0].strip():
        lines.pop(0)
    for ln in lines[::2]:
        if not ln.strip():
            continue
        parts = ln.split()
        out.append({
            "qvec": np.array([float(x) for x in parts[1:5]]),
            "tvec": np.array([float(x) for x in parts[5:8]]),
            "camera_id": int(parts[8]),
            "name": parts[9],
        })
    return out


def parse_points3d_txt(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    pts, cols = [], []
    for line in path.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        pts.append([float(x) for x in parts[1:4]])
        cols.append([int(x) for x in parts[4:7]])
    if not pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    return (np.asarray(pts, np.float32),
            np.asarray(cols, np.float32) / 255.0)


def colmap_pose_to_nerfstudio(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """COLMAP w2c -> nerfstudio transform_matrix (c2w, OpenGL camera,
    permuted world axes) — byte-for-byte the nerfstudio colmap_to_json
    conversion so downstream parsing matches reference datasets."""
    w2c = np.eye(4)
    w2c[:3, :3] = qvec2rotmat(qvec)
    w2c[:3, 3] = tvec
    c2w = np.linalg.inv(w2c)
    c2w[0:3, 1:3] *= -1                      # OpenCV -> OpenGL camera
    c2w = c2w[np.array([1, 0, 2, 3]), :]     # world axis swap (x<->y)
    c2w[2, :] *= -1                          # flip world z
    return c2w


def write_transforms_json(
    model_dir: Path, images_rel: str, out_path: Path,
    ply_rel: Optional[str] = None,
) -> Dict:
    """Convert a COLMAP TXT model directory to ``transforms.json``."""
    cams = parse_cameras_txt(model_dir / "cameras.txt")
    images = parse_images_txt(model_dir / "images.txt")
    if not images:
        raise ColmapError("COLMAP reconstructed zero registered images")
    frames = []
    for im in sorted(images, key=lambda d: d["name"]):
        c2w = colmap_pose_to_nerfstudio(im["qvec"], im["tvec"])
        frames.append({
            "file_path": f"{images_rel}/{im['name']}",
            "transform_matrix": c2w.tolist(),
            **cams[im["camera_id"]],
        })
    meta: Dict = {"camera_model": "OPENCV", "frames": frames}
    if ply_rel is not None:
        meta["ply_file_path"] = ply_rel
    with open(out_path, "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def run_colmap_sfm(
    images_dir: Path,
    out_dir: Path,
    matcher: str = "exhaustive",
    camera_model: str = "OPENCV",
    single_camera: bool = True,
    undistort: bool = True,
) -> Path:
    """Full SfM pipeline; returns the path of the written transforms.json.

    Args:
        images_dir: directory of input frames.
        out_dir: dataset root; transforms.json + colmap/ land here.
        matcher: "exhaustive" (image sets) or "sequential" (video frames).
        undistort: rectify images to a pinhole model with COLMAP's
            image_undistorter after mapping (the reference's
            ns-process-data does the same) — the dataparser is pinhole-
            only, so training directly on OPENCV-distorted frames would
            bake multi-pixel reprojection error into the splats.
    """
    if not colmap_available():
        raise ColmapError("colmap binary not found on PATH")
    images_dir = Path(images_dir)
    out_dir = Path(out_dir)
    colmap_dir = out_dir / "colmap"
    sparse = colmap_dir / "sparse"
    sparse.mkdir(parents=True, exist_ok=True)
    db = colmap_dir / "database.db"

    _run([
        "colmap", "feature_extractor",
        "--database_path", str(db),
        "--image_path", str(images_dir),
        "--ImageReader.camera_model", camera_model,
        "--ImageReader.single_camera", "1" if single_camera else "0",
        "--SiftExtraction.use_gpu", "0",
    ])
    matcher_cmd = {
        "exhaustive": "exhaustive_matcher",
        "sequential": "sequential_matcher",
    }[matcher]
    _run([
        "colmap", matcher_cmd,
        "--database_path", str(db),
        "--SiftMatching.use_gpu", "0",
    ])
    _run([
        "colmap", "mapper",
        "--database_path", str(db),
        "--image_path", str(images_dir),
        "--output_path", str(sparse),
    ])
    model0 = sparse / "0"
    if not model0.exists():
        raise ColmapError("COLMAP mapper produced no model")
    if undistort:
        und = out_dir / "undistorted"
        _run([
            "colmap", "image_undistorter",
            "--image_path", str(images_dir),
            "--input_path", str(model0),
            "--output_path", str(und),
            "--output_type", "COLMAP",
        ])
        model0 = und / "sparse"
        images_dir = und / "images"
    txt = colmap_dir / "txt"
    txt.mkdir(exist_ok=True)
    _run([
        "colmap", "model_converter",
        "--input_path", str(model0),
        "--output_path", str(txt),
        "--output_type", "TXT",
    ])

    return write_dataset_outputs(txt, images_dir, out_dir)


def write_dataset_outputs(txt: Path, images_dir: Path, out_dir: Path) -> Path:
    """Shared TXT-model -> (sparse ply + transforms.json) conversion used
    by BOTH SfM runners (colmap + hloc), so they emit identical dataset
    metadata by construction."""
    ply_rel = None
    pts, cols = parse_points3d_txt(txt / "points3D.txt")
    if len(pts):
        from ..data.ply import write_ply

        write_ply(str(out_dir / "sparse_points.ply"), pts, colors=cols)
        ply_rel = "sparse_points.ply"

    # A bare directory *name* only resolves when images_dir sits inside
    # out_dir; fall back to the absolute path otherwise.
    images_rel = str(images_dir.relative_to(out_dir)) \
        if images_dir.is_relative_to(out_dir) else str(images_dir)
    out_path = out_dir / "transforms.json"
    write_transforms_json(txt, images_rel, out_path, ply_rel)
    return out_path

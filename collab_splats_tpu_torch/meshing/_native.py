"""ctypes bindings for the C++ mesh-repair kernels (cpp/libmesh_repair.so).

The port's own copy of the JAX package's ``meshing/_native.py``.  Loaded
lazily; every entry point has a numpy path in repair.py, so the library is
an accelerator of host code, not a dependency.  When the library is
missing, the first call builds it with the repository's ``cpp/Makefile``
in a staging directory under ``build/`` and moves it into
``cpp/libmesh_repair.so`` in one rename, so a process that loads the path
at the same time never sees a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ROOT = Path(__file__).resolve().parents[2]


def _lib_path() -> Path:
    return _ROOT / "cpp" / "libmesh_repair.so"


def _build() -> Optional[Path]:
    """``make`` with cpp/Makefile on a copy of cpp/mesh_repair.cpp in a
    private staging directory; the staged library's path, or None when the
    build fails."""
    cpp = _lib_path().parent
    stage = _ROOT / "build" / "mesh_repair" / str(os.getpid())
    stage.mkdir(parents=True, exist_ok=True)
    try:
        shutil.copy(cpp / "mesh_repair.cpp", stage)
        subprocess.run(
            ["make", "-C", str(stage), "-f", str(cpp / "Makefile")],
            capture_output=True, timeout=120, check=True,
        )
    except Exception:
        return None
    built = stage / _lib_path().name
    return built if built.exists() else None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.face_components.restype = ctypes.c_int32
    lib.face_components.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, i32p]
    lib.boundary_edges.restype = ctypes.c_int32
    lib.boundary_edges.argtypes = [ctypes.c_int32, i32p, i32p]
    lib.weld_vertices.restype = ctypes.c_int32
    lib.weld_vertices.argtypes = [ctypes.c_int32, f32p, ctypes.c_double, i32p]
    return lib


def load(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if path.exists():
        try:
            _LIB = _bind(ctypes.CDLL(str(path)))
            return _LIB
        except OSError:
            pass   # another process is still writing it: build our own
    if not build_if_missing:
        return None
    built = _build()
    if built is None:
        return None
    # Loaded before the rename: the mapping stays valid whatever later
    # happens to either path.
    _LIB = _bind(ctypes.CDLL(str(built)))
    os.replace(built, path)
    return _LIB


def face_components(n_verts: int, faces: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, np.int32)
    out = np.empty(len(faces), np.int32)
    lib.face_components(np.int32(n_verts), np.int32(len(faces)), faces, out)
    return out


def boundary_edges(faces: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, np.int32)
    out = np.empty((len(faces) * 3, 2), np.int32)
    n = lib.boundary_edges(np.int32(len(faces)), faces, out)
    return out[:n]


def weld_vertices(points: np.ndarray, eps: float = 1e-6) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(points), np.int32)
    lib.weld_vertices(np.int32(len(points)), points, 1.0 / eps, out)
    return out

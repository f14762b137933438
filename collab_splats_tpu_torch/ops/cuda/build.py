"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface, under ``build/torch_kernels/`` of the checkout, named by
a hash of the source and the flags: a changed source builds anew, an
unchanged one is reused.  Nothing is built when a module is imported; the
first launch (or :func:`build_all`) builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("binning_kernel", "batched_fwd", "batched_bwd", "segsum_kernel",
           "composite_fwd", "composite_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The compositing kernels run one thread per pixel of a 16x16 tile.
KERNEL_TILE_SIZE = 16


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library that is not built yet, one nvcc per source,
    all started together.  Returns nvcc's output (register and shared
    memory use from ``-Xptxas -v``) per name built; raises on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_tensor(name, x, shape, dtype, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``, as a kernel's C interface takes it."""
    if x.shape != shape or x.dtype != dtype or x.device != device \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} "
                         f"{list(shape)} on {device}, got {x.dtype} "
                         f"{list(x.shape)} on {x.device}")


def check(rc: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")

"""The port's profiling helpers (``utils/profiling.py``) and its public API
against the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import collab_splats_tpu
import collab_splats_tpu_torch
from collab_splats_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def work(x):
    return torch.tanh(x @ x).sum()


def test_timed_is_positive_on_the_cpu():
    x = torch.randn(96, 96)
    t = profiling.timed(work, x, reps=(1, 4))
    assert 0.0 < t < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path / "t")) as path:
        work(x)
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_public_api_matches_jax():
    assert collab_splats_tpu_torch.__all__ == collab_splats_tpu.__all__
    for name in collab_splats_tpu_torch.__all__:
        obj = getattr(collab_splats_tpu_torch, name)
        assert obj.__module__.startswith("collab_splats_tpu_torch."), name
    with pytest.raises(AttributeError):
        collab_splats_tpu_torch.not_a_name


def test_import_is_lazy_and_builds_nothing():
    """A fresh ``import collab_splats_tpu_torch`` loads no JAX and none of
    the public names' modules; resolving a name loads its module only, and
    resolving them all loads no kernel library."""
    code = "\n".join([
        "import sys",
        "import collab_splats_tpu_torch as c",
        "from collab_splats_tpu_torch.ops.cuda import build",
        "mods = set(sys.modules)",
        "assert not any(m.split('.')[0] in ('jax', 'collab_splats_tpu')",
        "               for m in mods), sorted(mods)",
        "assert 'collab_splats_tpu_torch.train.trainer' not in mods",
        "assert 'collab_splats_tpu_torch.pipeline.splatter' not in mods",
        "c.render_golden",
        "assert 'collab_splats_tpu_torch.core.golden' in sys.modules",
        "assert 'collab_splats_tpu_torch.train.trainer' not in sys.modules",
        "[getattr(c, n) for n in c.__all__]",
        "assert build.load.cache_info().currsize == 0",
    ])
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)

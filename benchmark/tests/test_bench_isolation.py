"""No run holds JAX or the JAX package once its window has closed, and
the plain reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

import run as harness
from conftest import run_cell

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root, capsys):
    code, line = run_cell(tiny_root, "train-rade-gs-1m", capsys=capsys)
    assert code == 0 and line is not None
    assert harness.forbidden_modules() == []


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "collab_splats_tpu_torch_x",
                        types.ModuleType("collab_splats_tpu_torch_x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "collab_splats_tpu.core",
                        types.ModuleType("collab_splats_tpu.core"))
    assert harness.forbidden_modules() == ["collab_splats_tpu"]


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"collab_splats_tpu_torch", "collab_splats_tpu",
                        "jax", "jaxlib", "flax"}

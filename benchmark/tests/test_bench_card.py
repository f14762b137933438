"""On a card, at the cell's own size: the program passes its committed
limits and the TF32 control fails one.  Skips without a card; run on the
card with ``python -m pytest -m card benchmark/tests/test_bench_card.py``.
"""

import pytest

from conftest import ROOT
from test_bench_control import fails, readings


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.card
@pytest.mark.parametrize("cell", ["train-rade-gs-1m",
                                  "train-rade-features-1m"])
def test_control_at_the_cells_size(card, cell):
    out, limits = readings(ROOT, cell, 2147483999, card)
    assert fails(out["program"], limits) == []
    assert fails(out["tf32"], limits)

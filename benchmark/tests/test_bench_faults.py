"""The harness driven through a whole run on the CPU, with the timed path
broken underneath: ``correct`` has to come out false for each fault a
cell can have, under the committed limits, and true when nothing is
broken."""

import json

import pytest
import torch

from conftest import BENCH, run_cell, tiny_copy

COMMITTED = BENCH / "limits"


def committed_copy(tmp_path, cell):
    lim = json.loads((COMMITTED / f"{cell}.json").read_text())
    return tiny_copy(tmp_path, {k: v["limit"] for k, v in lim.items()
                                if not k.startswith("_")})


@pytest.mark.parametrize("cell", ["train-rade-gs-1m",
                                  "train-rade-features-1m"])
def test_a_sound_run_is_correct(tmp_path, capsys, cell):
    code, line = run_cell(committed_copy(tmp_path, cell), cell,
                          capsys=capsys)
    assert code == 0 and line["correct"], line


def test_a_step_that_leaves_its_state_unchanged(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    code, line = run_cell(committed_copy(tmp_path, "train-rade-gs-1m"),
                          "train-rade-gs-1m", capsys=capsys)
    assert code == 0 and not line["correct"]
    assert line["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tmp_path, capsys, monkeypatch):
    """The loss's per-pixel terms taken over the top half of the image."""
    from collab_splats_tpu_torch.models import rade_gs

    real = rade_gs.get_loss

    def half(outputs, image, *a, **kw):
        h = image.shape[0] // 2
        cut = {k: (v[:h] if torch.is_tensor(v) and v.dim() >= 2 else v)
               for k, v in outputs.items()}
        return real(cut, image[:h], *a, **kw)

    monkeypatch.setattr(rade_gs, "get_loss", half)
    code, line = run_cell(committed_copy(tmp_path, "train-rade-gs-1m"),
                          "train-rade-gs-1m", capsys=capsys)
    assert code == 0 and not line["correct"]


def test_the_refine_left_out(tmp_path, capsys, monkeypatch):
    """No refine runs, so the cull that the checked steps cross is lost."""
    from collab_splats_tpu_torch.train import strategy

    monkeypatch.setattr(strategy.StrategyConfig, "is_refine_step",
                        lambda self, step: False)
    code, line = run_cell(committed_copy(tmp_path, "train-rade-gs-1m"),
                          "train-rade-gs-1m", capsys=capsys)
    assert code == 0 and not line["correct"]
    assert line["compared"]["alive_mismatch"]["value"] > 0

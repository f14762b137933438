"""Card ms per densifying-phase training step of the span ``train.update``:
the guard, Adam and the strategy's statistics.  ``benchlib/spans.py``
has the arithmetic."""

from benchlib import spans


def read(layer):
    return spans.card_ms_per_step(layer, "densify", "train.update")

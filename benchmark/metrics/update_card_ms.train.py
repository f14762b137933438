"""Card ms per training step of the span ``train.update``: the stretch of
the device timeline of the guard, Adam and the strategy's statistics.
``benchlib/spans.py`` has the arithmetic."""

from benchlib import spans


def read(layer):
    return spans.card_ms_per_step(layer, "train", "train.update")

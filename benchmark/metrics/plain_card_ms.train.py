"""Device ms per training step outside the hand-written kernels.
``benchlib/readers.py`` has the arithmetic."""

from benchlib import readers


def read(layer):
    return readers.plain_card_ms(layer, "train")

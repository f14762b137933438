"""The training step's share of the card's float32 peak, in %.
``benchlib/readers.py`` has the arithmetic."""

from benchlib import readers


def read(layer):
    return readers.mfu(layer, "train")

"""The device's idle share of a traced box-segmentation window, in %.
``benchlib/readers.py`` has the arithmetic."""

from benchlib import readers


def read(layer):
    return readers.idle_pct(layer, "boxseg")

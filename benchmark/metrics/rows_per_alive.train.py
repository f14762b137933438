"""Rows the projection ran over per alive Gaussian in the traced training
steps: the sum of ``render.rows`` over that of ``render.alive``.
``benchlib/spans.py`` has the arithmetic."""

from benchlib import spans


def read(layer):
    return spans.ratio(layer, "train", "render.rows", "render.alive")

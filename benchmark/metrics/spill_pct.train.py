"""The share of splat-tile intersections that binning and the compositor
cut in the traced training steps, in %: the sum of ``render.spilled`` over
that of ``render.pairs``.  ``benchlib/spans.py`` has the arithmetic."""

from benchlib import spans


def read(layer):
    return spans.ratio(layer, "train", "render.spilled", "render.pairs",
                       scale=100.0)

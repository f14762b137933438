"""The share of splat-tile intersections that binning and the compositor
cut in the traced queries' renders, in %: the sum of ``render.spilled``
over that of ``render.pairs``.  ``benchlib/spans.py`` has the
arithmetic."""

from benchlib import spans


def read(layer):
    return spans.ratio(layer, "query", "render.spilled", "render.pairs",
                       scale=100.0)

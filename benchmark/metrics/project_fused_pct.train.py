"""The share of the projection's rows in the traced training steps that
the fused projection kernels ran over, in %: 100 times the sum of
``render.fused_rows`` over that of ``render.rows``.  A program without
the counter reports nothing.  ``benchlib/spans.py`` has the arithmetic."""

from benchlib import spans


def read(layer):
    return spans.ratio(layer, "train", "render.fused_rows", "render.rows",
                       scale=100.0)

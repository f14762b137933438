"""The share of the projection's rows in the traced queries' renders that
the fused projection kernels ran over, in %: 100 times the sum of
``render.fused_rows`` over that of ``render.rows``.  ``benchlib/spans.py``
has the arithmetic."""

from benchlib import spans


def read(layer):
    return spans.ratio(layer, "query", "render.fused_rows", "render.rows",
                       scale=100.0)

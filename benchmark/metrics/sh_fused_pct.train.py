"""The share of the SH colours' rows in the traced training steps that the
fused SH kernels ran over, in %: 100 times the sum of
``render.sh_fused_rows`` over that of ``render.sh_rows``.  A program
without the counters reports nothing.  ``benchlib/spans.py`` has the
arithmetic."""

from benchlib import spans


def read(layer):
    return spans.ratio(layer, "train", "render.sh_fused_rows",
                       "render.sh_rows", scale=100.0)

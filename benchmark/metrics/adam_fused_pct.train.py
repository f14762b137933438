"""The share of the elements that Adam updated in the traced training
steps that the fused update kernel ran over, in %: 100 times the sum of
``train.adam_fused_elems`` over that of ``train.adam_elems``.  A program
without the counters reports nothing.  ``benchlib/spans.py`` has the
arithmetic."""

from benchlib import spans


def read(layer):
    return spans.ratio(layer, "train", "train.adam_fused_elems",
                       "train.adam_elems", scale=100.0)

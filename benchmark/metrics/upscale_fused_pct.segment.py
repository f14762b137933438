"""The share of the segmented images' prompts whose mask upscaling the
fused kernel ran, in %: 100 times the sum of ``sam.fused_up`` over that of
``sam.prompts``.  A program without the counter reports nothing.
``benchlib/spans.py`` has the arithmetic."""

from benchlib import spans


def read(layer):
    return spans.ratio(layer, "segment", "sam.fused_up", "sam.prompts",
                       scale=100.0)

"""Card ms per image segmented of the spans ``sam.upscale``: the mask
decoder's output upscaling and mask product in every prompt batch.
``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "segment", "sam.upscale",
                                  "sam.image")

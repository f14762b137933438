"""Card ms per image segmented of the span ``sam.filter``: the automatic
masks' IoU and stability filter, upscaling, areas, NMS and boxes.
``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "segment", "sam.filter", "sam.image")

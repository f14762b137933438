"""Card ms per frame extracted of the span ``features.dinov2``: DINOv2's
input preparation and tower.  ``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "extract", "features.dinov2",
                                  "features.image")

"""Card ms per frame extracted of the span ``features.clip``: MaskCLIP's
input preparation and visual tower.  ``benchlib/units.py`` has the
arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "extract", "features.clip",
                                  "features.image")

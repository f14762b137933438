"""Card ms per frame extracted of the spans ``vit.attention``: every
attention of every block of both towers (MaskCLIP's value path is not
one).  ``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "extract", "vit.attention",
                                  "features.image")

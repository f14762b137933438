"""Card ms per image segmented of the span ``sam.encode``: SAM's image
encoder with the resize and normalisation.  ``benchlib/units.py`` has the
arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "segment", "sam.encode", "sam.image")

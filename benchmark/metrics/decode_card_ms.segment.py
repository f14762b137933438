"""Card ms per image segmented of the spans ``sam.decode``: every prompt
batch's prompt encoding and mask decoder.  ``benchlib/units.py`` has the
arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "segment", "sam.decode", "sam.image")

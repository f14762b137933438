"""Card ms per frame segmented on the object path of the span
``sam.encode``: SAM's image encoder with the resize and normalisation.
``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "boxseg", "sam.encode", "sam.image")

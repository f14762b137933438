"""Card ms per frame segmented on the object path of the span
``sam.decode``: the box prompts' encoding and the mask decoder, 64 boxes a
batch, kernel 8's upscaling inside.  ``benchlib/units.py`` has the
arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "boxseg", "sam.decode", "sam.image")

"""Card ms per frame segmented on the object path of the results: the
span ``sam.boxes`` (the masks upscaled to the frame, their areas and
boxes) and the span ``sync.sam`` (the one read of the non-empty masks and
their numbers).  ``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    parts = [units.card_ms_per_unit(layer, "boxseg", span, "sam.image")
             for span in ("sam.boxes", "sync.sam")]
    return None if None in parts else sum(parts)

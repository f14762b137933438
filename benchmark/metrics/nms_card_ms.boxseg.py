"""Card ms per frame segmented on the object path of the span
``yolo.nms``: the detector's thresholds and class-agnostic NMS on the host,
the stretch of the card's timeline it holds.  ``benchlib/units.py`` has
the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "boxseg", "yolo.nms", "sam.image")

"""Card ms per frame segmented on the object path of the span
``yolo.detect``: YOLOv8's letterbox and forward.  ``benchlib/units.py`` has
the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "boxseg", "yolo.detect", "sam.image")

"""Boxes kept by the detector's NMS per frame segmented on the object path:
the sum of the counter ``yolo.kept`` over the ``sam.image`` spans.
``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.count_per_unit(layer, "boxseg", "yolo.kept", "sam.image")

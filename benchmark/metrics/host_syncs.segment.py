"""Blocking device-to-host reads per image segmented (the program's
``sync.*`` spans, counter ``host_syncs``).  ``benchlib/units.py`` has the
arithmetic."""

from benchlib import units


def read(layer):
    return units.count_per_unit(layer, "segment", "host_syncs", "sam.image")

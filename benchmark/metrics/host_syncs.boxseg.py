"""Blocking device-to-host reads per frame segmented on the object path
(the program's ``sync.*`` spans, counter ``host_syncs``).
``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.count_per_unit(layer, "boxseg", "host_syncs", "sam.image")

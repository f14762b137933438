"""Blocking device-to-host reads of the program per query (its ``sync.*``
spans, counter ``host_syncs``; 0 where none was recorded), per call of
``query.similarity``.  The loop's own read of the map is not counted.
``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.count_per_unit(layer, "query", "host_syncs",
                                "query.similarity", absent=0.0)

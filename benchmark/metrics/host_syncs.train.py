"""Blocking device-to-host reads per training step (the program's
``sync.*`` spans, counter ``host_syncs``).  ``benchlib/spans.py`` has the
arithmetic."""

from benchlib import spans


def read(layer):
    return spans.count_per_step(layer, "train", "host_syncs")

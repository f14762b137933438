"""Gaussians duplicated or split per refine: the sums of the counters
``refine.duplicated`` and ``refine.split`` over the ``train.refine`` spans.
A program without the counters reports nothing.  ``benchlib/units.py``
has the arithmetic."""

from benchlib import units


def read(layer):
    parts = [units.count_per_unit(layer, "densify", c, "train.refine")
             for c in ("refine.duplicated", "refine.split")]
    return None if None in parts else sum(parts)

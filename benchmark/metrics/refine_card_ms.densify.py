"""Card ms per refine of the span ``train.refine``: the capacity check
and growth, the densifying refine (duplication, splits, culls) and the
Adam rows it zeroes.  ``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "densify", "train.refine",
                                  "train.refine")

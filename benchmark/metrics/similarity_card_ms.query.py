"""Card ms per call of the span ``query.similarity``: the decoder and the
similarity of one text query over a rendered view.  A program without the
span reports nothing.  ``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "query", "query.similarity",
                                  "query.similarity")

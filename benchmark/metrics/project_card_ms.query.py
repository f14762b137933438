"""Card ms per query of the span ``render.project``: the projection's
stretch of the device timeline in the query's forward render, per call of
``query.similarity`` (one a query).  A program without that span reports
nothing.  ``benchlib/units.py`` has the arithmetic."""

from benchlib import units


def read(layer):
    return units.card_ms_per_unit(layer, "query", "render.project",
                                  "query.similarity")

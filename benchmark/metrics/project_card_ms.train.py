"""Card ms per training step of the span ``render.project``: the
projection's stretch of the device timeline.  ``benchlib/spans.py`` has
the arithmetic."""

from benchlib import spans


def read(layer):
    return spans.card_ms_per_step(layer, "train", "render.project")

"""The segmented image's share of the card's float32 peak, in %: the
operations ``counts/sam.py`` counts for the configuration over the
untraced window's time per image.  ``benchlib/readers.py`` has the
arithmetic."""

from benchlib import readers


def read(layer):
    return readers.mfu(layer, "segment")

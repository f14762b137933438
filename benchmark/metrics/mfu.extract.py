"""The extracted frame's share of the card's float32 peak, in %: the
operations ``counts/vit.py`` counts for the configuration and the frame
size over the untraced window's time per frame.  ``benchlib/readers.py``
has the arithmetic."""

from benchlib import readers


def read(layer):
    return readers.mfu(layer, "extract")

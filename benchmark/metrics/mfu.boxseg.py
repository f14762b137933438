"""The segmented frame's share of the card's float32 peak, in %: the
operations ``counts/yolo.py`` counts for the configuration (YOLOv8's
convolutions, SAM's encoder, the decoder once a box) over the untraced
window's time per frame.  ``benchlib/readers.py`` has the arithmetic."""

from benchlib import readers


def read(layer):
    return readers.mfu(layer, "boxseg")

"""Kernel 3's (``csrc/batched_bwd.cu``) share of its roofline over the traced
training steps, in %. ``benchlib/readers.py`` has the arithmetic."""

from benchlib import readers


def read(layer):
    return readers.roofline(layer, "train", "composite_bwd_kernel")

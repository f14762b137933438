"""Frozen operation and byte counts of the kernels and of a whole step,
counted on the benchmark's own reference binning of a step's inputs, and
the table of the card's peaks.  Each count returns (bytes, float32
operations)."""

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12     # outside the tensor cores; TF32 is off


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card needs for this work: the larger of its
    bytes over the memory bandwidth and its operations over the float32
    peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)

"""Kernel 1, ``csrc/binning_kernel.cu``: the binning decode.

The formula of ``chip_smoke.py::decode_bound``, to be counted on the
reference binning's run lengths; no metric reads it yet.
"""


def count(n: int, owners: int, m_cap: int, live_slots: int,
          cull: bool = True) -> tuple:
    """Bytes: the int32 run ends of every Gaussian read once; offset,
    bbox width, first tile and rank, and with the cull its six float32
    columns, read once per Gaussian that owns a slot; an int32 key and
    gid per slot written once.  Operations: about 60 float32 operations
    of the ellipse cull per live slot."""
    per_owner = 16 + (24 if cull else 0)
    nbytes = 4 * n + per_owner * owners + 8 * m_cap
    return nbytes, (60 * live_slots if cull else 0)

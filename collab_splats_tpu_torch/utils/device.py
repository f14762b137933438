"""Device selection for the port's entry points: the card unless asked."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point creates its tensors on.

    ``None`` means the card.  Asking for a CUDA device on a machine without
    one raises instead of silently falling back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev

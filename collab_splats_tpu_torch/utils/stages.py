"""Host-clock seconds of a pipeline's stages, for callers that ask.

A :class:`StageTimer` over a dict appends each stage's seconds under its
name, synchronising the device at both ends so the time is the stage's
own; over ``None`` it times nothing and synchronises nothing.  Either way
a stage is the span ``mesh.<name>`` (``utils/profiling.py``) while a
profiler session records.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

from . import profiling


class StageTimer:
    def __init__(self, times: Optional[Dict[str, List[float]]],
                 device=None):
        self.times = times
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.times is not None:
            self._sync()
            t0 = time.perf_counter()
        with profiling.span(f"mesh.{name}"):
            yield
        if self.times is not None:
            self._sync()
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

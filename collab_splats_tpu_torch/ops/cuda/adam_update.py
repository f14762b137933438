"""Wrappers of the train step's update kernels (``csrc/adam_update.cu``):
the finite guard over every gradient of a step, and Adam over every
parameter tensor with the dead-row mask, one launch each.

They replace, on the card, the update's plain chain: a multiply by the
broadcast alive mask and an ``isfinite`` for each group, and
``torch.optim.Adam``'s foreach chain for each group; the JAX package has no
Pallas kernel there (XLA fuses optax's update).  The guard runs its plain
version for CPU tensors; the update takes CUDA tensors only, and off the
card ``train/optim.py::adam_step`` runs ``torch.optim.Adam`` itself.  The
optimizer's state stays where ``torch.optim.Adam`` keeps it: ``adam_step``
builds the entries from it and advances its step counts.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import build
from .build import check_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Tensors a launch takes (kMaxGroups and kMaxChecks in the source); the
# train step's tables hold at most 15 and 16.
MAX_GROUPS = 32
MAX_CHECKS = 64


class _Group(ctypes.Structure):
    _fields_ = [("p", _P), ("g", _P), ("m", _P), ("v", _P),
                ("n", ctypes.c_longlong), ("width", ctypes.c_longlong),
                ("step", _F), ("bc2_sqrt", _F), ("eps", _F), ("pad", _I)]


class _Check(ctypes.Structure):
    _fields_ = [("x", _P), ("n", ctypes.c_longlong)]


class AdamEntry(NamedTuple):
    """One parameter tensor's update: its gradient (None: zeros), its Adam
    moments, whether its rows follow the alive mask (a Gaussian group),
    and the step's scalars as torch's Adam computes them in float64:
    ``step_size`` -lr / (1 - b1^t), ``bc2_sqrt`` (1 - b2^t) ** 0.5."""
    param: torch.Tensor
    grad: Optional[torch.Tensor]
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    masked: bool
    step_size: float
    bc2_sqrt: float
    eps: float


def _check_count(what: str, n: int, most: int) -> None:
    if n > most:
        raise ValueError(f"{what}: {n} tensors, more than the {most} a "
                         "launch takes")


def _device(tensors) -> torch.device:
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"adam_update: tensors on {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"adam_update: unsupported device {dev}")
    return dev


def all_finite_plain(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where every element of every tensor is finite (0-d bool)."""
    return torch.stack([torch.isfinite(x).all() for x in tensors]).all()


def all_finite(tensors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """The guard: a 0-d bool on the tensors' device, true where every
    element of every tensor given is finite (None ones are skipped).  One
    launch on the card, the plain version on the CPU."""
    xs = [x for x in tensors if x is not None]
    dev = _device(xs)
    if dev.type == "cpu":
        return all_finite_plain(xs)
    xs = [x.contiguous() for x in xs if x.numel()]
    _check_count("adam_finite", len(xs), MAX_CHECKS)
    for x in xs:
        if x.dtype != torch.float32:
            raise ValueError(f"adam_finite: float32 only, got {x.dtype}")
    flag = torch.empty((), dtype=torch.bool, device=dev)
    if not xs:
        return flag.fill_(True)
    table = (_Check * len(xs))(*[_Check(x.data_ptr(), x.numel())
                                 for x in xs])
    fn = build.entry("adam_update", "adam_finite", _P, _I, _P)
    build.launch("adam_finite", fn, dev, ctypes.addressof(table), len(xs),
                 flag.data_ptr())
    return flag


def _group(e: AdamEntry, alive: torch.Tensor, dev):
    """The kernel's row of ``e`` and the gradient it reads (contiguous,
    or None); raises on what the kernel does not take."""
    p = e.param
    for name, x in (("param", p), ("exp_avg", e.exp_avg),
                    ("exp_avg_sq", e.exp_avg_sq)):
        check_tensor(f"adam_update: {name}", x, p.shape, torch.float32, dev)
    g = e.grad
    if g is not None:
        if g.shape != p.shape or g.dtype != torch.float32 or g.device != dev:
            raise ValueError(f"adam_update: gradient {g.dtype} "
                             f"{list(g.shape)} on {g.device} for a parameter "
                             f"{list(p.shape)} on {dev}")
        g = g.contiguous()
    width = 0
    if e.masked:
        if p.dim() == 0 or p.shape[0] != alive.shape[0]:
            raise ValueError(f"adam_update: a masked parameter "
                             f"{list(p.shape)} for {alive.shape[0]} rows")
        width = p.numel() // p.shape[0]
    return _Group(p.data_ptr(), None if g is None else g.data_ptr(),
                  e.exp_avg.data_ptr(), e.exp_avg_sq.data_ptr(), p.numel(),
                  width, e.step_size, e.bc2_sqrt, e.eps, 0), g


def adam_update(entries: Sequence[AdamEntry], alive: torch.Tensor,
                betas: Tuple[float, float]) -> int:
    """Adam over every entry, in place, with dead rows' gradients zeroed in
    the masked ones: one launch (none where every tensor is empty).
    Returns the elements the kernel ran over."""
    dev = _device([alive] + [e.param for e in entries])
    if dev.type != "cuda":
        raise ValueError(f"adam_update: CUDA tensors only, got {dev}")
    check_tensor("adam_update: alive", alive, alive.shape[:1], torch.bool,
                 dev)
    # (row, gradient) pairs: the gradients' contiguous copies stay
    # referenced until the launch.
    made = [_group(e, alive, dev) for e in entries if e.param.numel()]
    _check_count("adam_update", len(made), MAX_GROUPS)
    table = (_Group * len(made))(*[row for row, _ in made])
    n = sum(row.n for row in table)
    if n:
        beta1, beta2 = betas
        fn = build.entry("adam_update", "adam_update", _P, _I, _P, _F, _F,
                         _F)
        build.launch("adam_update", fn, dev, ctypes.addressof(table),
                     len(made), alive.data_ptr(), 1 - beta1, beta2,
                     1 - beta2)
    return n

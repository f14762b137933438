"""Process meshes for multi-device training, on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``.  One process drives
one device, and the processes form a (data, gauss) grid:

* ``data``: camera parallelism.  Each row renders its own training camera;
  the Gaussian gradients are averaged over this axis;
* ``gauss``: Gaussian-table parallelism.  The [C, ...] parameters, their
  Adam moments and the densification statistics are split along the
  capacity axis; each process projects its shard, and only the compact
  projected rows are all-gathered (the backward reduce-scatters them).

Rank ``r`` of a mesh's rank list sits at row ``r // n_gauss`` and column
``r % n_gauss``, so a ``gauss`` group holds consecutive ranks: with
``torchrun``'s host-major ranks it stays inside one host, and the ``data``
axis spans hosts (:func:`make_hybrid_mesh`).  The card takes NCCL and the
CPU gloo; every process must call :func:`make_mesh` in the same order,
because it creates the process groups of both axes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import gather_rows

DATA_AXIS = "data"
GAUSS_AXIS = "gauss"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class Mesh:
    """A (data, gauss) grid of processes as this process sees it.

    ``ranks`` are the global ranks, row-major; ``data_idx`` and
    ``gauss_idx`` are this process's row and column (-1 when it is not in
    the mesh); ``groups`` maps each axis to the process group of this
    process's row (``gauss``) or column (``data``).
    """

    n_data: int
    n_gauss: int
    ranks: tuple
    device: torch.device
    data_idx: int
    gauss_idx: int
    groups: Dict[str, object]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, GAUSS_AXIS: self.n_gauss}

    @property
    def member(self) -> bool:
        return self.data_idx >= 0

    def index(self, axis: str) -> int:
        return self.data_idx if axis == DATA_AXIS else self.gauss_idx

    def group(self, axis: str):
        return self.groups[axis]


def _backend(device_type: str) -> str:
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if device_type == "cuda":
        resolve_device("cuda")   # raises on a machine without a card
    return _BACKENDS[device_type]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> int:
    """Join the process group (idempotent; a no-op in a single process).

    With ``num_processes > 1``, ``coordinator_address`` (``host:port`` or
    an init-method URL) and ``process_id`` initialise the group
    explicitly.  A coordinator without ``num_processes > 1`` is a caller's
    error.  With no arguments, a launcher's environment (``torchrun`` sets
    ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) is read
    through ``env://``; without one nothing happens.  The backend is NCCL
    for ``"cuda"`` (the default, which needs a card) and gloo for
    ``"cpu"``.  Returns this process's rank.
    """
    backend = _backend(device_type)
    if dist.is_initialized():
        return dist.get_rank()
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator_address "
                             "and process_id")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    elif coordinator_address is not None:
        # N independent jobs that each believe they are "the" job would
        # follow from going on here.
        raise ValueError(
            "coordinator_address given but num_processes is "
            f"{num_processes!r}; pass num_processes > 1 and process_id")
    elif num_processes is None and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank() if dist.is_initialized() else 0


def _local_device(device_type: str, rank: int) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_mesh(
    n_data: Optional[int] = None,
    n_gauss: int = 1,
    device_type: str = "cuda",
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """A (data, gauss) mesh over ``ranks`` (every rank of the initialised
    process group by default), on the card (``"cuda"``, NCCL) or the CPU
    (``"cpu"``, gloo).  Every process of the group calls it; processes
    outside ``ranks`` get a mesh with ``member`` False."""
    _backend(device_type)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "(or torch.distributed.init_process_group) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world)) if ranks is None else sorted(ranks)
    if n_data is None:
        n_data = len(ranks) // n_gauss
    if n_data * n_gauss != len(ranks):
        raise ValueError(f"mesh {n_data}x{n_gauss} != {len(ranks)} ranks")
    rows = [ranks[i * n_gauss:(i + 1) * n_gauss] for i in range(n_data)]
    cols = [ranks[j::n_gauss] for j in range(n_gauss)]
    groups = {}
    for axis, lines in ((GAUSS_AXIS, rows), (DATA_AXIS, cols)):
        for line in lines:
            # Every process creates every group, in the same order.
            group = dist.group.WORLD if len(line) == world \
                else dist.new_group(ranks=line)
            if rank in line:
                groups[axis] = group
    pos = ranks.index(rank) if rank in ranks else -1
    return Mesh(
        n_data=n_data, n_gauss=n_gauss, ranks=tuple(ranks),
        device=_local_device(device_type, rank),
        data_idx=pos // n_gauss if pos >= 0 else -1,
        gauss_idx=pos % n_gauss if pos >= 0 else -1,
        groups=groups,
    )


def make_hybrid_mesh(
    n_data_per_host: Optional[int] = None,
    n_gauss: int = 1,
    device_type: str = "cuda",
) -> Mesh:
    """(data, gauss) mesh spanning hosts: ``gauss`` stays inside a host
    (its all-gather and reduce-scatter move the projected rows every
    step) and ``data`` rows are host-major, so the gradient all-reduce
    crosses hosts.  A host's process count is ``LOCAL_WORLD_SIZE``
    (``torchrun``); in one host this is :func:`make_mesh`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_data_per_host is None:
        n_data_per_host = local // n_gauss
    if n_data_per_host * n_gauss != local:
        raise ValueError(f"per-host mesh {n_data_per_host}x{n_gauss} != "
                         f"{local} local processes")
    return make_mesh((world // local) * n_data_per_host, n_gauss,
                     device_type)


def shard(x: torch.Tensor, mesh: Mesh, axis: str = GAUSS_AXIS
          ) -> torch.Tensor:
    """This process's block of ``x``'s leading axis, split over ``axis``
    (the port's counterpart of ``gauss_sharding`` / ``data_sharding``)."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split into "
                         f"{n}")
    size = x.shape[0] // n
    i = mesh.index(axis)
    return x[i * size:(i + 1) * size]


def unshard(x: torch.Tensor, mesh: Mesh, axis: str = GAUSS_AXIS
            ) -> torch.Tensor:
    """The whole tensor from each process's block along ``axis``: an
    all-gather of the leading axis, not differentiated (bool tensors
    travel as bytes)."""
    if x.dtype == torch.bool:
        return gather_rows(x.to(torch.uint8), mesh.group(axis)).bool()
    return gather_rows(x, mesh.group(axis))

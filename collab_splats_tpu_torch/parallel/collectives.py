"""Differentiable collectives over one axis of a process mesh.

The JAX package writes its collectives inside ``shard_map`` and XLA
transposes them; here each is a ``torch.autograd.Function`` whose backward
is that transpose:

* :func:`all_gather_rows`: the tiled all-gather of a leading axis (the
  projected rows over ``gauss``, and the band all-gather of the pixel maps
  in ``parallel/tiles.py``); its backward reduce-scatters (sums) the
  cotangent, so each block's owner receives the sum of every member's
  cotangent for its rows;
* :func:`all_to_all_rows`: block ``j`` of member ``i`` goes to member
  ``j`` as its block ``i``; its backward is the same exchange of the
  cotangent, which sends every block back where it came from.

They use ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single``, which NCCL and gloo both provide.  The leading axis
splits into equal blocks, one per member, in group-rank order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n * N, ...] from every member's [N, ...], in group-rank order; not
    differentiated."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def scatter_sum_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This member's [N, ...] block of the sum over members of their
    [n * N, ...] tensors (a reduce-scatter); not differentiated."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def exchange_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The all-to-all of equal leading blocks; not differentiated."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, ct):
        return scatter_sum_rows(ct, ctx.group), None


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange_rows(x, group)

    @staticmethod
    def backward(ctx, ct):
        return exchange_rows(ct, ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-gather of ``x``'s leading axis over ``group``; the
    backward is a reduce-scatter (sum)."""
    return _AllGatherRows.apply(x, group)


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of ``x``'s equal leading blocks over ``group``; the
    backward is the reverse all-to-all."""
    return _AllToAllRows.apply(x, group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (not differentiated)."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out

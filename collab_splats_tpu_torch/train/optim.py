"""Per-group Adam with the reference's learning-rate table.

Counterpart of the JAX package's ``train/optim.py``: one Adam(eps=1e-15)
per parameter group with nerfstudio's exponential-decay schedules.  Here it
is one ``torch.optim.Adam`` with one param group per parameter key (the
group carries the key as ``"name"``; the rade-features ``"decoder"`` group
holds every tensor of the decoder) and a ``LambdaLR`` that scales each
group's rate by its schedule.  optax's schedule counts from 0 at the first
update, and so does ``LambdaLR``.  optax divides by ``sqrt(nu / (1 -
b2^t)) + eps`` where torch divides by ``sqrt(nu) / sqrt(1 - b2^t) + eps``:
the same function, rounded otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    lr: float
    lr_final: Optional[float] = None
    max_steps: int = 30000
    warmup_steps: int = 0
    lr_pre_warmup: float = 1e-8
    eps: float = 1e-15


# The reference optimizer table.
RADE_GS_GROUPS: Dict[str, GroupSpec] = {
    "means": GroupSpec(lr=1.6e-4, lr_final=1.6e-6, max_steps=30000),
    "features_dc": GroupSpec(lr=2.5e-3),
    "features_rest": GroupSpec(lr=2.5e-3 / 20.0),
    "opacities": GroupSpec(lr=5e-2),
    "scales": GroupSpec(lr=5e-3),
    "quats": GroupSpec(lr=1e-3),
}

RADE_FEATURES_GROUPS: Dict[str, GroupSpec] = {
    **RADE_GS_GROUPS,
    "distill_features": GroupSpec(lr=2.5e-3, lr_final=5e-4, max_steps=10000),
    "decoder": GroupSpec(lr=1e-3),
}


def nerfstudio_exponential_decay(spec: GroupSpec) -> Callable[[int], float]:
    """nerfstudio ExponentialDecayScheduler: sine warmup from
    ``lr_pre_warmup`` to ``lr``, then a log-space lerp from ``lr`` to
    ``lr_final`` over ``max_steps``."""
    lr_final = spec.lr_final if spec.lr_final is not None else spec.lr

    def schedule(step: int) -> float:
        if step < spec.warmup_steps:
            frac = min(max(step / spec.warmup_steps, 0.0), 1.0)
            return spec.lr_pre_warmup + (spec.lr - spec.lr_pre_warmup) \
                * math.sin(0.5 * math.pi * frac)
        t = (step - spec.warmup_steps) / max(
            spec.max_steps - spec.warmup_steps, 1)
        t = min(max(t, 0.0), 1.0)
        return math.exp(math.log(spec.lr) * (1.0 - t)
                        + math.log(lr_final) * t)

    return schedule


def make_optimizer(
        params: Mapping[str, Union[torch.Tensor, Sequence[torch.Tensor]]],
        groups: Dict[str, GroupSpec]):
    """(Adam, LambdaLR) over the leaf tensors ``params``: one group per key
    (a key may hold a list of tensors, as ``"decoder"`` does), each with
    its own rate, schedule and eps."""
    names = list(params)
    opt = torch.optim.Adam(
        [{"params": list(params[k]) if isinstance(params[k], (list, tuple))
          else [params[k]], "lr": groups[k].lr, "eps": groups[k].eps,
          "name": k} for k in names],
        betas=(0.9, 0.999))
    factors = []
    for k in names:
        spec = groups[k]
        factors.append(lambda step, f=nerfstudio_exponential_decay(spec),
                       lr=spec.lr: f(step) / lr)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factors)


def group_param(optimizer: torch.optim.Optimizer, name: str) -> torch.Tensor:
    """The parameter tensor of the group named ``name``."""
    for group in optimizer.param_groups:
        if group["name"] == name:
            return group["params"][0]
    raise KeyError(name)


def zero_group_moments(optimizer: torch.optim.Optimizer, name: str) -> None:
    """Zero the Adam moments of one group, in place, keeping its step count
    (bias correction stays consistent).  Used on opacity reset: otherwise
    the accumulated momentum pushes the clamped opacities straight back."""
    state = optimizer.state.get(group_param(optimizer, name))
    if state:
        state["exp_avg"].zero_()
        state["exp_avg_sq"].zero_()


def graft_opt_state(optimizer: torch.optim.Optimizer,
                    new_params: Dict[str, torch.Tensor]) -> None:
    """Swap each group's parameter for its grown copy in ``new_params`` and
    carry its Adam state over: surviving rows keep their moments, new rows
    start at zero, the step count is kept.  Groups not in ``new_params``
    (the decoder) are left as they are."""
    for group in optimizer.param_groups:
        if group["name"] not in new_params:
            continue
        old = group["params"][0]
        new = new_params[group["name"]]
        group["params"][0] = new
        state = optimizer.state.pop(old, None)
        if not state:
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            grown = torch.zeros_like(new)
            grown[:old.shape[0]] = state[key]
            state[key] = grown
        optimizer.state[new] = state

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

The trainer steps it with :func:`adam_step`, the dead rows' gradients of
the Gaussian groups zeroed: on the card one kernel updates every group in
the optimizer's own state (``ops/cuda/adam_update.py``), on the CPU
``optimizer.step()`` runs on the masked gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Collection, Dict, Mapping, Optional, Sequence,
                    Union)

import torch

from ..ops.cuda import adam_update
from ..utils import profiling


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


def adam_step(optimizer: torch.optim.Adam,
              grads: Mapping[str, Sequence[Optional[torch.Tensor]]],
              alive: torch.Tensor, masked: Collection[str]) -> int:
    """One step of ``optimizer`` with ``grads``, each group's gradients by
    its name in the order of its tensors (None: zeros); the groups named in
    ``masked`` hold Gaussian rows, whose gradients are zeroed where
    ``alive`` is false.  On the card it is one launch of kernel 10 over
    every tensor, in place in the optimizer's state, which is created and
    whose step counts advance as ``optimizer.step()`` does them (plain Adam
    only: no weight decay, amsgrad or maximize); on the CPU the masked
    gradients go through ``optimizer.step()``.  Returns the elements
    updated."""
    fused = 0
    if alive.device.type == "cuda":
        fused = _fused_step(optimizer, grads, alive, masked)
    else:
        amask = alive.to(torch.float32)
        for group in optimizer.param_groups:
            for p, g in zip(group["params"], grads[group["name"]],
                            strict=True):
                g = torch.zeros_like(p) if g is None else g
                if group["name"] in masked:
                    g = g * amask.reshape((-1,) + (1,) * (g.dim() - 1))
                p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
    elems = sum(p.numel() for group in optimizer.param_groups
                for p in group["params"])
    profiling.count("train.adam_elems", elems)
    profiling.count("train.adam_fused_elems", fused)
    return elems


def _fused_step(optimizer, grads, alive, masked) -> int:
    states, entries, betas = [], [], set()
    for group in optimizer.param_groups:
        if group["amsgrad"] or group["weight_decay"] or group["maximize"]:
            raise ValueError("adam_step: plain Adam only")
        beta1, beta2 = group["betas"]
        betas.add((beta1, beta2))
        for p, g in zip(group["params"], grads[group["name"]], strict=True):
            state = optimizer.state.get(p) or {
                "step": torch.tensor(0.0, dtype=torch.float32),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}
            states.append((p, state))
            t = state["step"].item() + 1
            entries.append(adam_update.AdamEntry(
                p.detach(), g, state["exp_avg"], state["exp_avg_sq"],
                group["name"] in masked, -(group["lr"] / (1 - beta1 ** t)),
                (1 - beta2 ** t) ** 0.5, group["eps"]))
    if len(betas) != 1:
        raise ValueError(f"adam_step: one pair of betas, got {betas}")
    fused = adam_update.adam_update(entries, alive, betas.pop())
    for p, state in states:
        state["step"] += 1
        optimizer.state[p] = state
    return fused


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

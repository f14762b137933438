"""Checkpoint save / load / resume in the JAX package's format.

Counterpart of the JAX package's ``train/checkpoint.py``: one
``step-XXXXXXXX.ckpt.npz`` per save and a ``metadata.json`` sidecar.  The
npz keys are the JAX package's, so a checkpoint written by either package
resumes in the other:

* ``params/<k>`` for each per-Gaussian tensor, ``params/decoder/<k>`` for
  the rade-features decoder in JAX's [in, out] layout, and ``alive``;
* ``opt/.inner_states/['<group>']/.inner_state/[0]/.count`` (Adam's update
  count), ``.../[0]/.mu/['<group>']`` and ``.nu`` (its moments; the
  decoder's under ``.../.mu/['decoder']/['<k>']``), and
  ``.../[1]/.count`` (the schedule's count): optax's state as the JAX
  package's ``_flatten`` names it;
* ``strat/.grad_accum``, ``strat/.count``, ``strat/.max_radii``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..features import decoder as decoder_lib
from ..models.gaussians import GaussianParams
from ..utils.device import resolve_device
from . import strategy

DECODER_PREFIX = "params/decoder/"


def _group_prefix(name: str) -> str:
    return f"opt/.inner_states/['{name}']/.inner_state/"


def _opt_leaves(optimizer: torch.optim.Optimizer,
                decoder: Optional[decoder_lib.TwoLayerDecoder]
                ) -> Iterator[Tuple[str, str, Optional[str], torch.Tensor]]:
    """(group, the key path of its moments, the decoder key or None, the
    parameter tensor) for every tensor the optimizer updates."""
    names = {}
    if decoder is not None:
        names = {id(t): k for k, t in
                 decoder_lib.decoder_tensors(decoder).items()}
    for group in optimizer.param_groups:
        name = group["name"]
        for p in group["params"]:
            if name == "decoder":
                key = names[id(p)]
                yield name, f"['decoder']/['{key}']", key, p
            else:
                yield name, f"['{name}']", None, p


def optimizer_to_flat(optimizer: torch.optim.Optimizer,
                      decoder: Optional[decoder_lib.TwoLayerDecoder] = None
                      ) -> Dict[str, np.ndarray]:
    """The optimizer's Adam state under the JAX package's ``opt/`` keys
    (moments of a parameter not yet updated are zeros)."""
    flat = {}
    for name, path, dkey, p in _opt_leaves(optimizer, decoder):
        st = optimizer.state.get(p, {})
        pre = _group_prefix(name)
        count = np.asarray(int(st["step"]) if st else 0, np.int32)
        flat[pre + "[0]/.count"] = count
        flat[pre + "[1]/.count"] = count
        for moment, key in ((".mu", "exp_avg"), (".nu", "exp_avg_sq")):
            x = (st[key] if st else torch.zeros_like(p)).detach().cpu()
            x = x.numpy()
            if dkey is not None:
                x = decoder_lib.jax_layout(dkey, x)
            flat[f"{pre}[0]/{moment}/{path}"] = x
    return flat


def load_optimizer_flat(optimizer: torch.optim.Optimizer,
                        scheduler: torch.optim.lr_scheduler.LambdaLR,
                        flat: Mapping[str, np.ndarray],
                        decoder: Optional[decoder_lib.TwoLayerDecoder] = None
                        ) -> None:
    """Take over Adam state written under the JAX package's ``opt/`` keys:
    each parameter's moments where both are present with its shape (the
    others start from zero), and every group's update count, which also
    sets the schedules' position.  A group the checkpoint does not hold
    keeps its state."""
    counts = set()
    for name, path, dkey, p in _opt_leaves(optimizer, decoder):
        pre = _group_prefix(name)
        if pre + "[0]/.count" not in flat:
            continue     # a group the checkpoint lacks starts afresh
        count = int(flat[pre + "[0]/.count"])
        counts.add(count)
        moments = []
        for moment in (".mu", ".nu"):
            x = flat.get(f"{pre}[0]/{moment}/{path}")
            if x is not None and dkey is not None:
                x = decoder_lib.torch_layout(dkey, x)
            moments.append(x if x is not None
                           and tuple(x.shape) == tuple(p.shape) else None)
        if any(m is None for m in moments):
            moments = [np.zeros(tuple(p.shape), np.float32)] * 2
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(moments[0], device=p.device),
            "exp_avg_sq": torch.tensor(moments[1], device=p.device),
        }
    if len(counts) > 1:
        raise ValueError(f"groups disagree on the update count: {counts}")
    if not counts:
        return
    count = counts.pop()
    scheduler.last_epoch = count
    scheduler._last_lr = [base * f(count) for base, f in
                          zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, scheduler._last_lr):
        group["lr"] = lr


def strategy_from_flat(flat: Mapping[str, np.ndarray], capacity: int,
                       device) -> strategy.StrategyState:
    """The densification statistics under the ``strat/`` keys, each where
    it has ``capacity`` rows, else zeros."""
    out = []
    for name in strategy.StrategyState._fields:
        x = flat.get(f"strat/.{name}")
        out.append(torch.tensor(x, device=device) if x is not None
                   and x.shape == (capacity,)
                   else torch.zeros(capacity, device=device))
    return strategy.StrategyState(*out)


def save_checkpoint(
    directory: str | Path,
    step: int,
    params: GaussianParams,
    alive: torch.Tensor,
    decoder: Optional[decoder_lib.TwoLayerDecoder] = None,
    optimizer: Optional[torch.optim.Optimizer] = None,
    strat_state: Optional[strategy.StrategyState] = None,
    metadata: Optional[Dict] = None,
) -> Path:
    """Write ``step-{step:08d}.ckpt.npz`` (and ``metadata.json`` when
    ``metadata`` is given); returns the checkpoint's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    payload = {f"params/{k}": v.detach().cpu().numpy()
               for k, v in params.items()}
    if decoder is not None:
        payload.update({DECODER_PREFIX + k: v for k, v in
                        decoder_lib.decoder_to_numpy(decoder).items()})
    payload["alive"] = alive.cpu().numpy()
    if optimizer is not None:
        payload.update(optimizer_to_flat(optimizer, decoder))
    if strat_state is not None:
        payload.update({f"strat/.{name}": x.cpu().numpy() for name, x in
                        zip(strategy.StrategyState._fields, strat_state)})
    path = directory / f"step-{step:08d}.ckpt.npz"
    np.savez_compressed(path, **payload)
    if metadata is not None:
        with open(directory / "metadata.json", "w") as f:
            json.dump({"step": step, **metadata}, f, indent=2, default=str)
    return path


def latest_checkpoint(directory: str | Path) -> Optional[Path]:
    """The checkpoint of the highest step in ``directory``, or None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(directory.glob("step-*.ckpt.npz"))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str | Path, device=None) -> Tuple[
        int, GaussianParams, torch.Tensor, Dict[str, np.ndarray]]:
    """(step, params, alive, extras) of a checkpoint: the per-Gaussian
    tensors and the alive mask on ``device`` (the card by default), and
    every other array as numpy under its key: the ``opt/`` and ``strat/``
    state and the decoder's ``params/decoder/<k>`` (see
    :func:`decoder_arrays`)."""
    dev = resolve_device(device)
    path = Path(path)
    m = re.match(r"step-(\d+)\.ckpt\.npz", path.name)
    step = int(m.group(1)) if m else 0
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    params = {k.split("/", 1)[1]: torch.tensor(v, device=dev)
              for k, v in arrays.items()
              if k.startswith("params/") and not k.startswith(DECODER_PREFIX)}
    alive = torch.tensor(arrays["alive"], device=dev)
    extras = {k: v for k, v in arrays.items()
              if k != "alive" and (k.startswith(DECODER_PREFIX)
                                   or not k.startswith("params/"))}
    return step, params, alive, extras


def decoder_arrays(extras: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The decoder's arrays of a checkpoint's extras, under the JAX
    package's names and layout (for ``decoder_from_numpy``); empty when
    the checkpoint holds no decoder."""
    return {k[len(DECODER_PREFIX):]: v for k, v in extras.items()
            if k.startswith(DECODER_PREFIX)}

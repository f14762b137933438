"""What the loops share: the configuration's check against the
program, the comparison of numbers with their limits, and the counts of a
render on the reference binning."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import torch

from counts import (composite_batched_bwd, composite_batched_fwd,
                    least_seconds, step)
from reference import render as R
from reference import train as RT
from reference.precision import Products


class Compared(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # False for NaN on either side


def check_config(tcfg, groups, optimizer, cfg: dict) -> None:
    """Raise unless the program's trainer configuration, optimizer table
    and Adam betas are the values the configuration's file states."""
    bad = []
    model = tcfg.model
    for key, want in cfg["model"].items():
        if key == "render":
            for rk, rw in want.items():
                got = getattr(model.render, rk)
                if got != rw:
                    bad.append(f"render.{rk}: {got!r} != {rw!r}")
            continue
        got = getattr(model, key)
        if key == "feature_dims":
            got = {n: list(d) for n, d in got}
        if got != want:
            bad.append(f"model.{key}: {got!r} != {want!r}")
    for key, want in cfg["trainer"].items():
        if getattr(tcfg, key) != want:
            bad.append(f"trainer.{key}: {getattr(tcfg, key)!r} != {want!r}")
    for key, want in cfg["strategy"].items():
        if getattr(tcfg.strategy, key) != want:
            bad.append(f"strategy.{key}: {getattr(tcfg.strategy, key)!r} "
                       f"!= {want!r}")
    table = cfg["optimizer"]["groups"]
    if set(groups) != set(table):
        bad.append(f"optimizer groups {sorted(groups)} != {sorted(table)}")
    for name, spec in groups.items():
        if name in table and dataclasses.asdict(spec) != table[name]:
            bad.append(f"optimizer.{name}: {dataclasses.asdict(spec)} != "
                       f"{table[name]}")
    betas = list(optimizer.param_groups[0]["betas"])
    if betas != cfg["optimizer"]["betas"]:
        bad.append(f"betas {betas} != {cfg['optimizer']['betas']}")
    if bad:
        raise ValueError("the program does not run the configuration's "
                         "file: " + "; ".join(bad))


def compare(numbers: Dict[str, float], limits: Dict[str, dict]
            ) -> List[Compared]:
    """Each number beside its limit (``limits[name]["limit"]``).  A
    number with no limit gets -1, which no gap passes."""
    return [Compared(n, float(v),
                     float(limits[n]["limit"]) if n in limits else -1.0)
            for n, v in numbers.items()]


def gap_by_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keys: Optional[List[str]] = None) -> float:
    """The worst leaf's |program norm - reference norm|, against the
    larger of that leaf's reference norm and the median leaf's."""
    keys = list(ref) if keys is None else keys
    vals = sorted(ref[k] for k in ref)
    median = vals[len(vals) // 2] if len(vals) % 2 else \
        0.5 * (vals[len(vals) // 2 - 1] + vals[len(vals) // 2])
    worst = 0.0
    for k in keys:
        worst = max(worst, abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30))
    return worst


class RenderWork(NamedTuple):
    tiles: int
    k: int
    v: int
    masked_slots: int
    live_pairs: int
    alive: int
    bases: int
    pixels: int


@torch.no_grad()
def render_work(params, alive, cam: R.Cam, step_: int, model: dict
                ) -> RenderWork:
    """The work of one render of these inputs, counted on the reference
    binning."""
    prec = Products(False)
    per_gauss, bins = RT._prepare(params, alive, cam, step_, model, prec)
    masked, live = R.pair_counts(per_gauss, bins, model["render"])
    t, k = bins.tile_gauss.shape
    sh = model["sh_degree"]
    active = min(int(step_) // model["sh_degree_interval"], sh) if sh else 0
    return RenderWork(t, k, per_gauss.shape[1] - 9, masked, live,
                      int(alive.sum()), (active + 1) ** 2,
                      cam.width * cam.height)


def kernel_bounds(w: RenderWork) -> Dict[str, float]:
    """Least seconds of kernels 2 and 3 on this render's work."""
    return {
        "composite_kernel": least_seconds(*composite_batched_fwd.count(
            w.tiles, w.k, w.v, w.masked_slots, w.live_pairs)),
        "composite_bwd_kernel": least_seconds(*composite_batched_bwd.count(
            w.tiles, w.k, w.v, w.masked_slots, w.live_pairs)),
    }


def train_ops(w: RenderWork, adam_elements: int, model: dict,
              height: int, width: int) -> float:
    """Useful operations of one training step with this render's work."""
    feats = 0
    if model.get("latent_dim"):
        feats = step.features_fwd(
            height, width, model["latent_dim"], model["mlp_hidden_dim"],
            {n: tuple(d) for n, d in model["feature_dims"].items()},
            model["main_feature_name"])
    return step.train_step(w.alive, w.bases, w.v, w.tiles, w.k,
                           w.masked_slots, w.live_pairs, w.pixels,
                           adam_elements, feats)

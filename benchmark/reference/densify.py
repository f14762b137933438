"""Plain reference of a densifying refine: splatfacto's duplicate, split
and cull rules (gsplat's ``DefaultStrategy`` as nerfstudio's Splatfacto
drives it) over a fixed-capacity table with an alive mask.

Plain PyTorch, float32, no kernel; it imports nothing of the program.
Given the table, the alive mask, the accumulated statistics (the screen
gradients' sum, the visibility count, the largest screen radius as a
share of the image) and the split children's normal draws, a refine at
``step``:

* takes a row's mean screen gradient, the sum over the count; a live row
  whose mean passes ``densify_grad_thresh`` and that was seen is a
  candidate;
* splits a candidate whose largest scale passes ``densify_size_thresh``
  times the scene scale (while screen sizes count: also one whose radius
  passes ``split_screen_size``) into ``n_split_samples`` children, each
  at the mean plus the rotated, scaled draw, its scales divided by
  ``split_scale_factor``; duplicates the other candidates;
* culls live rows whose opacity is under ``cull_alpha_thresh``, once
  scale culling is on those whose largest scale passes
  ``cull_scale_thresh`` times the scene scale, and while screen sizes
  count those whose radius passes ``cull_screen_size``; a culled row is
  neither split nor duplicated;
* writes the children into the free rows (dead or culled, lowest first):
  every split's children first, source by source, then one copy per
  duplicate; a split whose last child finds no free row is not made and
  its source stays, a duplicate without a free row is dropped;
* a row is alive after the refine if it was alive, is not culled and
  was not split, or was written.

Dup and split run inside the densification window past the pause after
each opacity reset; the table's growth ahead of the refine is the
trainer's and is not modelled here.  The departure from gsplat, as the
program has it: the table keeps its capacity, so children go to free
rows in a fixed order and the split sources' rows are left dead rather
than compacted away.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch


def rotation(quats: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] rotations of [N, 4] wxyz quaternions, normalised."""
    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


class Refined(NamedTuple):
    params: Dict[str, torch.Tensor]
    alive: torch.Tensor
    written: torch.Tensor
    duplicated: torch.Tensor   # [C] the duplicated sources
    split: torch.Tensor        # [C] the split sources (made or not)
    culled: torch.Tensor       # [C]


def schedule(step: int, s: dict, num_views: int) -> Dict[str, bool]:
    """Which rules run at a refine step, from the strategy's settings."""
    period = s["reset_alpha_every"] * s["refine_every"]
    densify = step < s["stop_split_at"] and \
        step % period > num_views + s["refine_every"]
    return {"densify": densify, "scale_cull": step > period,
            "screen": step < s["stop_screen_size_at"]}


def refine(params: Dict[str, torch.Tensor], alive: torch.Tensor,
           grad_sum: torch.Tensor, count: torch.Tensor,
           max_radii: torch.Tensor, noise: torch.Tensor, step: int,
           s: dict, scene_scale: float, num_views: int) -> Refined:
    """One refine of the table (see the module's docstring); ``noise``
    [n_split_samples, C, 3] the children's draws, ``s`` the
    configuration's ``strategy``."""
    rules = schedule(step, s, num_views)
    scales = torch.exp(params["scales"])
    biggest = scales.max(dim=1).values
    opacity = torch.sigmoid(params["opacities"][:, 0])
    mean_grad = grad_sum / count.clamp(min=1.0)
    candidate = alive & (count > 0) & (mean_grad > s["densify_grad_thresh"])
    large = biggest > s["densify_size_thresh"] * scene_scale
    split = candidate & large
    if rules["screen"]:
        split |= candidate & (max_radii > s["split_screen_size"])
    dup = candidate & ~large & ~split
    if not rules["densify"]:
        split = torch.zeros_like(split)
        dup = torch.zeros_like(dup)
    culled = alive & (opacity < s["cull_alpha_thresh"])
    if rules["scale_cull"]:
        culled |= alive & (biggest > s["cull_scale_thresh"] * scene_scale)
        if rules["screen"]:
            culled |= alive & (max_radii > s["cull_screen_size"])
    split &= ~culled
    dup &= ~culled

    n = s["n_split_samples"]
    free = torch.nonzero(~alive | culled).flatten()
    split_src = torch.nonzero(split).flatten()
    dup_src = torch.nonzero(dup).flatten()
    made = min(len(split_src), len(free) // n)
    # The items in order: split k's child j at k * n + j, then the dups.
    items_src = torch.cat([split_src[:made].repeat_interleave(n),
                           dup_src])
    items_child = torch.cat([torch.arange(n, device=alive.device).repeat(
        made), torch.full((len(dup_src),), -1, device=alive.device)])
    first_dup = len(split_src) * n
    dup_slots = torch.arange(first_dup, first_dup + len(dup_src),
                             device=alive.device)
    slots = torch.cat([torch.arange(made * n, device=alive.device),
                       dup_slots])
    fits = slots < len(free)
    items_src, items_child, slots = items_src[fits], items_child[fits], \
        slots[fits]
    rows = free[slots]

    out = {k: v.detach().clone() for k, v in params.items()}
    for k in out:
        out[k][rows] = params[k][items_src]
    is_child = items_child >= 0
    src, child = items_src[is_child], items_child[is_child]
    offset = torch.einsum("nij,nj->ni", rotation(params["quats"][src]),
                          scales[src] * noise[child, src])
    out["means"][rows[is_child]] = params["means"][src] + offset
    out["scales"][rows[is_child]] = torch.log(
        (scales[src] / s["split_scale_factor"]).clamp(min=1e-10))
    written = torch.zeros_like(alive)
    written[rows] = True
    gone = torch.zeros_like(alive)
    gone[split_src[:made]] = True
    return Refined(out, (alive & ~culled & ~gone) | written, written, dup,
                   split, culled)


def mismatch(prog: Dict[str, torch.Tensor], ref: Refined,
             tol: float = 1e-5) -> float:
    """Rows on which a program's refine and the reference's differ:
    the alive and written masks, the duplicated, split and culled counts,
    and the written rows whose parameters differ by more than ``tol`` of
    the row's largest value (``prog``: ``alive``, ``written``, ``params``
    and the counts ``n_dup``, ``n_split``, ``n_cull``)."""
    bad = float((prog["alive"] != ref.alive).sum()) + \
        float((prog["written"] != ref.written).sum())
    for name, mask in (("n_dup", ref.duplicated), ("n_split", ref.split),
                       ("n_cull", ref.culled)):
        bad += abs(int(prog[name]) - int(mask.sum()))
    rows = torch.nonzero(ref.written & prog["written"]).flatten()
    for k, v in ref.params.items():
        a = prog["params"][k][rows].reshape(len(rows), -1)
        b = v[rows].reshape(len(rows), -1)
        scale = b.abs().amax(dim=1).clamp(min=1.0)
        bad += float(((a - b).abs().amax(dim=1) > tol * scale).sum())
    return bad if math.isfinite(bad) else math.inf

"""Plain reference of one text query of a rade-features scene: the
evaluation render's latent map, the two-layer decoder's main branch and the
pairwise similarity, at the RGB resolution.

Plain PyTorch, float32, importing nothing of the program.  The render is
``reference/render.py``'s through ``reference/train.py``'s helpers (the
latents are the composited values after the normal and colour columns);
the latent map is resized to ``resize_factor`` times the main tower's map
(``jax.image.resize``'s linear rule, as ``train.resize``), decoded by the
shared ReLU layer and the main branch, and scored as collab-splats'
``compute_similarity(method="pairwise")`` does: raw dot products with the
embeddings (positives first), the averaged positives repeated once per
negative beside the negatives, one softmax at temperature 0.05 over all of
them, the smallest of the positive rows.  The map is resized back to the
image's size.  Every product goes through :class:`~.precision.Products`.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import render as R
from . import train as RT
from .precision import Products

SOFTMAX_TEMP = 0.05


def latents(params: Dict[str, torch.Tensor], alive: torch.Tensor,
            cam: R.Cam, step: int, model: dict,
            prec: Products) -> torch.Tensor:
    """The evaluation render's [H, W, L] latent map."""
    per_gauss, bins = RT._prepare(params, alive, cam, step, model, prec)
    tiles = R.composite_maps(per_gauss, bins, model["render"], prec)
    vals, _, _, _ = RT._images(tiles, bins, cam, model["render"])
    return vals[..., 6:6 + model["latent_dim"]]


def similarity(features: torch.Tensor, emb: torch.Tensor, num_positive: int,
               prec: Products) -> torch.Tensor:
    """[h, w, 1] pairwise similarity of [h, w, C] features against [N, C]
    embeddings, positives first."""
    h, w, _ = features.shape
    raw = prec.einsum("hwc,nc->nhw", features, emb).reshape(emb.shape[0], -1)
    pos, neg = raw[:num_positive], raw[num_positive:]
    avg = pos.mean(dim=0, keepdim=True).expand_as(neg)
    probs = torch.softmax(torch.cat([avg, neg]) / SOFTMAX_TEMP, dim=0)
    sim = torch.nan_to_num(probs[:neg.shape[0]].amin(dim=0), nan=0.0)
    return sim.reshape(h, w, 1)


@torch.no_grad()
def similarity_map(params: Dict[str, torch.Tensor], alive: torch.Tensor,
                   cam: R.Cam, step: int, model: dict,
                   dec: Dict[str, torch.Tensor], emb: torch.Tensor,
                   num_positive: int, resize_factor: float,
                   prec: Products) -> torch.Tensor:
    """The [H, W, 1] similarity map of one query on one view."""
    main = model["main_feature_name"]
    _, mh, mw = model["feature_dims"][main]
    x = RT.resize(latents(params, alive, cam, step, model, prec),
                  (int(mh * resize_factor), int(mw * resize_factor)), prec)
    hid = torch.relu(prec.linear(x, dec["hidden_w"], dec["hidden_b"]))
    f = prec.linear(hid, dec[f"branch_{main}_w"], dec[f"branch_{main}_b"])
    sim = similarity(f, emb, num_positive, prec)
    return RT.resize(sim, (cam.height, cam.width), prec)

"""Text-query similarity maps over decoded CLIP features.

Counterpart of the JAX package's ``features/similarity.py``: raw cosine
similarities between per-pixel features and text embeddings, a tempered
softmax over the query axis; "standard" sums the positives'
probabilities, "pairwise" plays the averaged positives against each
negative and keeps the smallest win probability.
"""

from __future__ import annotations

import torch


def compute_similarity(
    features: torch.Tensor,
    text_embeddings: torch.Tensor,
    num_positive: int,
    softmax_temp: float = 0.05,
    method: str = "standard",
) -> torch.Tensor:
    """Similarity probability map [H, W, 1].

    Args:
        features: [C, H, W] decoded feature map.
        text_embeddings: [N, C] unit-normalized embeddings, positives first.
        num_positive: how many leading rows of ``text_embeddings`` are
            positive queries.
        softmax_temp: softmax temperature.
        method: "standard" | "pairwise".
    """
    _, h, w = features.shape
    raw = torch.einsum("chw,nc->nhw", features, text_embeddings)
    raw = raw.reshape(raw.shape[0], -1)                      # [N, H*W]
    if method == "standard":
        probs = torch.softmax(raw / softmax_temp, dim=0)
        sim = torch.sum(probs[:num_positive], dim=0)
    elif method == "pairwise":
        pos, neg = raw[:num_positive], raw[num_positive:]
        avg_pos = torch.mean(pos, dim=0, keepdim=True).expand_as(neg)
        probs = torch.softmax(torch.cat([avg_pos, neg], dim=0)
                              / softmax_temp, dim=0)
        sim = torch.nan_to_num(torch.amin(probs[:neg.shape[0]], dim=0),
                               nan=0.0)
    else:
        raise ValueError(f"Unknown method: {method}")
    return sim.reshape(h, w, 1)

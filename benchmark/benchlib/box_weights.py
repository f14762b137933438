"""Seeded SAM decoder weights whose box-prompted masks are localised.

:func:`benchlib.sam_weights.localise` builds a decoder whose masks are
blobs around a point prompt's token: it tags the foreground point's
embedding (``prompt.point_embed.1``) with the channels its attention
reads.  A box prompt is two corner tokens, SAM's point embeddings 2 and 3
added to the corners' positions, which that decoder leaves untagged, so
every box mask comes out empty.  Nor can a corner take the padding
token's part as the attention's sink: a corner token carries its position,
so near a small box's other corner the sink would draw the attention
away.  :func:`localise_boxes` builds the same decoder, tags both corner
embeddings as the point's, each with content of its own, and makes the
IoU token, which has no position, the sink.  A box's single mask (token 0,
at slot 0's threshold) is then the blobs around its two corners, one blob
where the box is small, and its edges move with the image's embedding as
a point's do.  (A point prompt on these weights has two sinks and smaller
masks; the box path falls back to the point grid only on a frame without
a box.)
"""

from __future__ import annotations

from typing import Dict

import torch

from benchlib import sam_weights

Params = Dict[str, torch.Tensor]


def localise_boxes(p: Params, generator: torch.Generator) -> None:
    """:func:`sam_weights.localise` on ``p`` in place, then the corner
    embeddings set; ``generator`` draws both's numbers."""
    sam_weights.localise(p, generator)
    dev = p["dec.iou_token"].device
    content = torch.tensor(sam_weights.CONTENT, device=dev)
    for j in (2, 3):
        e = p[f"prompt.point_embed.{j}"]
        e[sam_weights.TAG] = 8.0
        e[sam_weights.IDENT] = 8.0
        e[content] = torch.randn(len(content), generator=generator,
                                 device=dev)
    p["dec.iou_token"][sam_weights.ONE] = sam_weights.SINK

"""Plain reference of MobileSAMv2's object-aware segmentation: the YOLOv8
box prompter's kept boxes prompt SAM, one mask a box.

Plain PyTorch, float32, no kernel, no cache and no batching across images
or boxes; it imports nothing of the program.  The image encoder, the
prompt's Fourier positions and the two-way mask decoder are
``reference/sam.py``'s, by import; the detector is ``reference/yolo.py``'s.
Written from ``segment_anything``'s ``PromptEncoder._embed_boxes`` and
``SamPredictor.predict_torch`` (arXiv:2304.02643) and MobileSAMv2's
``Inference.py`` (arXiv:2312.09579):

* a box (x1, y1, x2, y2) in image pixels is scaled to the 1024 input and
  becomes two tokens, the Fourier positions of its corners (each shifted
  by half a pixel) plus SAM's point embeddings 2 and 3; no padding token;
* the decoder runs with one mask output (mask token 0) and its IoU;
* the logits are upscaled to the image and thresholded at 0; a mask's
  area is its pixel count and its box the XYWH extent of its pixels.

Departures, each as the program has it: empty masks are dropped (SAM
returns them); the masks are upscaled as ``reference/sam.py::upscale``
does (its own departures); MobileSAMv2 decodes its boxes in batches of
320 with SAM's mask-to-box refinement off, the program in batches of 64,
which changes no number.  ``Precision(tf32=True)`` is ``reference/sam.py``'s
TF32 control.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import sam as R


def box_tokens(p: R.Params, box_xyxy: torch.Tensor,
               corners=(2, 3)) -> torch.Tensor:
    """One box in 1024-space -> [2, 256]: its two corner tokens (another
    ``corners`` than SAM's embeddings 2 and 3 is a fault for the
    check)."""
    pe = R.fourier((box_xyxy.reshape(2, 2) + 0.5) / R.IMG, p)
    return pe + torch.stack([p[f"prompt.point_embed.{j}"] for j in corners])


def low_logits(p: R.Params, embedding: torch.Tensor, boxes: torch.Tensor,
               scale: float, prec: R.Precision, corners=(2, 3)):
    """([K, 256, 256] logits, [K] predicted IoUs) of [K, 4] boxes in image
    pixels, one box at a time, ``scale`` to the 1024 input."""
    pe = R.dense_pe(p)
    lows, ious = [], []
    with torch.no_grad():
        for box in boxes.to(torch.float32):
            low, iou = R.decode(p, embedding, pe,
                                box_tokens(p, box * scale, corners), prec,
                                multimask=False)
            lows.append(low[0])
            ious.append(iou[0])
    if not lows:
        empty = torch.zeros((0, 4 * R.GRID, 4 * R.GRID),
                            device=embedding.device)
        return empty, empty[:, 0, 0]
    return torch.stack(lows), torch.stack(ious)


class Image(NamedTuple):
    embedding: torch.Tensor   # [256, 64, 64]
    low: torch.Tensor         # [K, 256, 256], one a box
    iou: torch.Tensor         # [K]
    kept: List[dict]          # the non-empty masks, in the boxes' order


def segment_boxes(p: R.Params, image: torch.Tensor, boxes: torch.Tensor,
                  prec: R.Precision, embedding=None, corners=(2, 3)
                  ) -> Image:
    """Box-prompted masks of one [H, W, 3] image (pixels 0..255) for
    [K, 4] boxes in its pixels.  Kept masks are dicts with the box's
    index ``box``, ``predicted_iou``, ``area``, ``bbox`` (XYWH) and the
    boolean ``segmentation``.  ``embedding`` reuses an image's embedding;
    ``corners``: :func:`box_tokens`'."""
    h, w = image.shape[:2]
    scale = R.IMG / max(h, w)
    input_hw = (int(round(h * scale)), int(round(w * scale)))
    with torch.no_grad():
        emb = R.encode(p, R.preprocess(image), prec) if embedding is None \
            else embedding
        low, iou = low_logits(p, emb, boxes, scale, prec, corners)
        kept = []
        for j in range(len(low)):
            seg = R.upscale(low[j][None], (h, w), input_hw)[0] > 0
            area = int(seg.sum())
            if area == 0:
                continue
            ys, xs = torch.nonzero(seg, as_tuple=True)
            x0, y0 = int(xs.min()), int(ys.min())
            kept.append({"box": j, "predicted_iou": float(iou[j]),
                         "area": area,
                         "bbox": [x0, y0, int(xs.max()) - x0,
                                  int(ys.max()) - y0],
                         "segmentation": seg})
    return Image(emb, low, iou, kept)

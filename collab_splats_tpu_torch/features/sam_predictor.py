"""SAM predictor and automatic mask generation over the SAM modules.

Counterpart of the JAX package's ``features/sam_predictor.py``, which
mirrors the reference's two segmentation entry points:

* :meth:`SamBackend.segment_boxes`: box-prompted segmentation (the
  MobileSAMv2 + detector path), in batches of 64 boxes;
* :meth:`SamBackend.auto_segment`: point-grid automatic masks
  (``SamAutomaticMaskGenerator``): a grid of foreground points, multimask
  output, filtering by predicted IoU and stability on the 256x256 logits,
  then greedy mask NMS.

The towers run on the backend's ``device`` (the card unless the caller
passes ``device="cpu"``); results come back to the host in the reference's
dict format (segmentation, area, bbox, predicted_iou, stability_score),
which ``features/grouping.py`` consumes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from . import sam as S
from .decoder import resize_bilinear
from .vit import load_params
from .weights import find_weights

_MEAN = (123.675, 116.28, 103.53)
_STD = (58.395, 57.12, 57.375)


def sam_available() -> bool:
    return find_weights("sam_vit_b.npz") is not None


class SamBackend:
    """Stateful predictor (one ``set_image``, many prompts), as
    SamPredictor."""

    def __init__(self, weights_npz: Optional[str] = None, device=None):
        path = weights_npz or find_weights("sam_vit_b.npz")
        if path is None:
            raise RuntimeError(
                "SAM weights not found: convert a segment-anything "
                "checkpoint with scripts/convert_sam.py and place "
                "sam_vit_b.npz under weights/."
            )
        self.device = resolve_device(device)
        self.params = load_params(path, self.device)
        self.has_encoder = "enc.patch_embed.w" in self.params
        self._pe = S.dense_pe(self.params)
        self._embedding: Optional[torch.Tensor] = None
        self._orig_hw: Tuple[int, int] = (0, 0)
        self._input_hw: Tuple[int, int] = (0, 0)
        self._scale = 1.0

    # ------------------------------------------------------------ predictor
    @torch.no_grad()
    def set_image(self, image: np.ndarray,
                  embedding: Optional[np.ndarray] = None) -> None:
        """Embed an [H, W, 3] uint8 or float image (longest side -> 1024).

        ``embedding`` injects a [256, 64, 64] embedding from an external
        encoder (the MobileSAM-distilled path)."""
        h, w = image.shape[:2]
        self._orig_hw = (h, w)
        self._scale = S.IMG_SIZE / max(h, w)
        th, tw = int(round(h * self._scale)), int(round(w * self._scale))
        self._input_hw = (th, tw)
        if embedding is not None:
            self._embedding = torch.as_tensor(
                np.asarray(embedding, np.float32), device=self.device)
            return
        if not self.has_encoder:
            raise RuntimeError(
                "this weights file is decoder-only; pass `embedding=`"
            )
        img = np.asarray(image, np.float32)
        if img.max() <= 1.0 + 1e-6:
            img = img * 255.0
        x = resize_bilinear(torch.as_tensor(img, device=self.device),
                            (th, tw))
        mean = torch.tensor(_MEAN, device=self.device)
        std = torch.tensor(_STD, device=self.device)
        padded = torch.zeros((S.IMG_SIZE, S.IMG_SIZE, 3), device=self.device)
        padded[:th, :tw] = (x - mean) / std
        self._embedding = S.sam_encoder_forward(self.params, padded)

    def _decode(self, sparse: torch.Tensor, multimask: bool):
        return S.mask_decoder_forward(self.params, self._embedding, self._pe,
                                      sparse, multimask=multimask)

    @torch.no_grad()
    def predict_boxes(self, boxes_xyxy: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """[B, 4] boxes in original pixels -> ([B, H, W] bool, [B] iou)."""
        assert self._embedding is not None, "call set_image first"
        boxes = torch.as_tensor(np.asarray(boxes_xyxy, np.float32),
                                device=self.device) * self._scale
        low, iou = self._decode(S.encode_boxes(self.params, boxes), False)
        masks = S.postprocess_masks(low, self._orig_hw, self._input_hw)
        return (masks[:, 0] > 0.0).cpu().numpy(), iou[:, 0].cpu().numpy()

    @torch.no_grad()
    def predict_points(
        self, points: np.ndarray, multimask: bool = True
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """[B, 2] single foreground points -> ([B, M, H, W] logits > 0,
        [B, M] iou, [B, M, H, W] raw logits)."""
        low, iou = self.predict_points_low(points, multimask=multimask)
        masks = S.postprocess_masks(
            torch.as_tensor(low, device=self.device), self._orig_hw,
            self._input_hw).cpu().numpy()
        return masks > 0.0, iou, masks

    @torch.no_grad()
    def predict_points_low(
        self, points: np.ndarray, multimask: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """[B, 2] points -> ([B, M, 256, 256] raw logits, [B, M] iou), not
        upscaled: quality filtering runs at this resolution (as in
        SamAutomaticMaskGenerator), so only the survivors pay the resize."""
        assert self._embedding is not None, "call set_image first"
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.device)[:, None, :] * self._scale
        labels = torch.ones(pts.shape[:2], dtype=torch.int32,
                            device=self.device)
        low, iou = self._decode(S.encode_points(self.params, pts, labels),
                                multimask)
        return low.cpu().numpy(), iou.cpu().numpy()

    # ----------------------------------------------------------- reference
    def segment_boxes(self, image: np.ndarray, boxes_xyxy: np.ndarray,
                      confs: Optional[np.ndarray] = None,
                      batch_size: int = 64) -> List[Dict]:
        """Box-prompted segmentation in the reference's result format."""
        self.set_image(image)
        results: List[Dict] = []
        h, w = image.shape[:2]
        confs = np.ones(len(boxes_xyxy)) if confs is None else confs
        for s0 in range(0, len(boxes_xyxy), batch_size):
            masks, ious = self.predict_boxes(boxes_xyxy[s0 : s0 + batch_size])
            for mask, iou, conf in zip(
                masks, ious, confs[s0 : s0 + batch_size]
            ):
                area = int(mask.sum())
                if area == 0:
                    continue
                ys, xs = np.where(mask)
                results.append({
                    "segmentation": mask,
                    "area": area,
                    "bbox": [int(xs.min()), int(ys.min()),
                             int(xs.max() - xs.min()), int(ys.max() - ys.min())],
                    "predicted_iou": float(iou),
                    "point_coords": [],
                    "stability_score": float(conf),
                    "crop_box": [0, 0, w, h],
                })
        return results

    def auto_segment(
        self,
        image: np.ndarray,
        points_per_side: int = 16,
        pred_iou_thresh: float = 0.7,
        stability_offset: float = 1.0,
        stability_thresh: float = 0.85,
        nms_iou: float = 0.7,
        min_area: int = 64,
    ) -> List[Dict]:
        """Point-grid automatic masks (SamAutomaticMaskGenerator's rules:
        multimask per point, IoU and stability filtering, greedy mask NMS
        by predicted IoU)."""
        self.set_image(image)
        h, w = image.shape[:2]
        g = (np.arange(points_per_side) + 0.5) / points_per_side
        pts = np.stack(np.meshgrid(g * w, g * h), axis=-1).reshape(-1, 2)

        # Filter on the 256x256 logits and resize only the survivors.
        survivors: List[np.ndarray] = []
        meta: List[Tuple[float, float, list]] = []
        for s0 in range(0, len(pts), 64):
            low, ious = self.predict_points_low(pts[s0 : s0 + 64])
            b, m = low.shape[:2]
            for bi in range(b):
                for mi in range(m):
                    iou = float(ious[bi, mi])
                    if iou < pred_iou_thresh:
                        continue
                    lg = low[bi, mi]
                    inter = float((lg > stability_offset).sum())
                    union = float((lg > -stability_offset).sum())
                    stab = inter / max(union, 1.0)
                    if stab < stability_thresh:
                        continue
                    survivors.append(lg)
                    meta.append((iou, stab, [pts[s0 + bi].tolist()]))

        cands: List[Dict] = []
        for s0 in range(0, len(survivors), 32):
            batch = torch.as_tensor(np.stack(survivors[s0 : s0 + 32]),
                                    device=self.device)[:, None]
            with torch.no_grad():
                masks = (S.postprocess_masks(batch, self._orig_hw,
                                             self._input_hw)
                         > 0.0)[:, 0].cpu().numpy()
            for mask, (iou, stab, pc) in zip(masks, meta[s0 : s0 + 32]):
                area = int(mask.sum())
                if area < min_area:
                    continue
                cands.append({
                    "segmentation": mask, "area": area,
                    "predicted_iou": iou, "stability_score": stab,
                    "point_coords": pc,
                    "crop_box": [0, 0, w, h],
                })
        # Greedy NMS on masks by predicted IoU.
        cands.sort(key=lambda r: -r["predicted_iou"])
        kept: List[Dict] = []
        for r in cands:
            keep = True
            for k in kept:
                inter = np.logical_and(r["segmentation"], k["segmentation"]).sum()
                union = np.logical_or(r["segmentation"], k["segmentation"]).sum()
                if union and inter / union > nms_iou:
                    keep = False
                    break
            if keep:
                ys, xs = np.where(r["segmentation"])
                r["bbox"] = [int(xs.min()), int(ys.min()),
                             int(xs.max() - xs.min()), int(ys.max() - ys.min())]
                kept.append(r)
        return kept

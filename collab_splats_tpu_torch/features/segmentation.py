"""Segmentation: mask generation and mask/feature aggregation.

Counterpart of the JAX package's ``features/segmentation.py`` (the
reference's ``utils/segmentation.py``).  Mask generation is pluggable:

* SAM with YOLOv8 box prompts (``object_segment_image``), SAM's point-grid
  automatic masks, or, without converted weights, the download-free
  ``FelzenszwalbLiteSegmenter``, in the JAX package's order of preference;
* all give SAM-style ``{"segmentation", "predicted_iou", ...}`` dicts.

The mask utilities (``create_patch_mask``, ``create_composite_mask``,
``mask_id_to_binary_mask``, ``convert_matched_mask``) and the classical
segmenter are host numpy, own copies of the JAX package's.
``aggregate_masked_features`` pools features within each mask and paints
the pooled vector back over it, on the device of its tensors, with JAX's
linear and nearest resizes.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .decoder import resize_bilinear


# ----------------------------------------------------------- mask utilities


def create_patch_mask(image: np.ndarray, num_patches: int = 32) -> np.ndarray:
    """[P, P, H*W] bool: which flattened pixels fall in each patch."""
    h, w = image.shape[:2]
    patch_w = math.ceil(w / num_patches)
    patch_h = math.ceil(h / num_patches)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    py = np.clip(ys // patch_h, 0, num_patches - 1).reshape(-1)
    px = np.clip(xs // patch_w, 0, num_patches - 1).reshape(-1)
    out = np.zeros((num_patches, num_patches, h * w), bool)
    out[py, px, np.arange(h * w)] = True
    return out


def create_composite_mask(
    results: List[Dict], confidence_threshold: float = 0.85
) -> np.ndarray:
    """Merge per-object masks into one uint8 id map, higher-confidence masks
    painting last; overlapped remnants under 10%% of their original mask are
    dropped (reference :276-321)."""
    selected = [
        (m["segmentation"], m["predicted_iou"])
        for m in results
        if confidence_threshold <= m["predicted_iou"] <= 1.0
    ]
    if not selected:
        return np.zeros(results[0]["segmentation"].shape[:2], np.uint8)
    masks, confs = zip(*selected)
    # uint8 id maps hold at most 255 object ids; keep the HIGHEST-
    # confidence masks when a cluttered frame produces more (assigning
    # id 256 overflows on numpy>=2 and silently wrapped to background
    # before).
    order = np.argsort(confs)
    if len(order) > 255:
        order = order[-255:]
    h, w = masks[0].shape[:2]
    mask_id = np.zeros((h, w), np.uint8)
    for i, idx in enumerate(order, start=1):
        mask_id[masks[idx] == 1] = i

    composite = np.zeros((h, w), np.uint8)
    next_id = 1
    for idx in np.setdiff1d(np.unique(mask_id), [0]):
        m = mask_id == idx
        orig = masks[order[idx - 1]]
        if m.sum() > 0 and m.sum() / max(orig.sum(), 1) > 0.1:
            composite[m] = next_id
            next_id += 1
    return composite


def mask_id_to_binary_mask(composite_mask: np.ndarray) -> np.ndarray:
    """(N, H, W) bool stack from an integer id map (0 = background)."""
    ids = np.unique(composite_mask)
    ids = ids[ids > 0]
    return composite_mask[None, ...] == ids[:, None, None]


def convert_matched_mask(labels: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Replace sequential mask ids 1..N with matched labels + 1."""
    labels = np.asarray(labels)
    assert labels.shape[0] == int(masks.max()), (
        "Number of labels must match number of unique masks"
    )
    matched = np.zeros(masks.shape, np.uint16)
    for i in range(labels.shape[0]):
        matched[masks == i + 1] = int(labels[i]) + 1
    return matched.astype(np.uint8)


def _resize_nearest(x: torch.Tensor, size: Tuple[int, int],
                    axes: Tuple[int, int]) -> torch.Tensor:
    """JAX's ``jax.image.resize(..., "nearest")`` on two axes: output
    sample i reads input floor((i + 0.5) * n_in / n_out), in float32."""
    for axis, n_out in zip(axes, size):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device)
               + 0.5) * n_in / n_out
        x = x.index_select(axis, torch.floor(pos).to(torch.int64))
    return x


def aggregate_masked_features(
    features: torch.Tensor,
    masks: torch.Tensor,
    resolution: Tuple[int, int],
    final_resolution: Tuple[int, int],
) -> torch.Tensor:
    """Mask-pooled feature aggregation.

    Args:
        features: [C, H, W] dense feature map.
        masks: [N, H', W'] binary masks.
        resolution: intermediate (h, w) both are resampled to.
        final_resolution: output (h, w).

    Returns:
        [C, h_out, w_out]: each pixel carries the average of the pooled
        vectors of the masks covering it (pixels with no mask keep 0).
    """
    f = resize_bilinear(features, resolution, axes=(1, 2))
    m = _resize_nearest(masks.to(torch.float32), resolution, axes=(1, 2))
    area = m.sum(dim=(1, 2))                                  # [N]
    pooled = torch.einsum("nhw,chw->nc", m, f) \
        / torch.clamp(area, min=1.0)[:, None]                 # [N, C]
    painted = torch.einsum("nhw,nc->chw", m, pooled)
    counts = m.sum(dim=0)                                     # [h, w]
    agg = painted / torch.clamp(counts, min=1e-6)[None]
    return resize_bilinear(agg, final_resolution, axes=(1, 2))


# ------------------------------------------------------------- segmenters


class FelzenszwalbLiteSegmenter:
    """Classical region segmenter: quantized color + connected components.

    Produces SAM-auto-mask-style results (list of ``{"segmentation",
    "predicted_iou", "area"}``) with a synthetic confidence derived from
    region compactness, so downstream consumers (composite mask, grouping)
    behave exactly as with SAM outputs.
    """

    def __init__(self, n_colors: int = 8, min_area: int = 64,
                 smooth: int = 2):
        self.n_colors = n_colors
        self.min_area = min_area
        self.smooth = smooth

    def __call__(self, image: np.ndarray) -> List[Dict]:
        img = np.asarray(image, np.float64)
        if img.max() > 1.5:
            img = img / 255.0
        h, w = img.shape[:2]
        if self.smooth > 0:
            k = self.smooth * 2 + 1
            pad = np.pad(img, ((k // 2,) * 2, (k // 2,) * 2, (0, 0)), "edge")
            sm = np.zeros_like(img)
            for dy in range(k):
                for dx in range(k):
                    sm += pad[dy : dy + h, dx : dx + w]
            img = sm / (k * k)
        # Quantize colors.
        q = np.floor(img * (self.n_colors - 1e-9)).astype(np.int32)
        labels_c = (
            q[..., 0] * self.n_colors**2 + q[..., 1] * self.n_colors
            + q[..., 2]
        )
        # Connected components of equal color: scipy's C labeling per
        # quantized color value (a pure-Python union-find over ~4M pixel
        # edges took minutes per 1080p frame).
        from scipy import ndimage

        comp = np.zeros((h, w), np.int64)
        n_total = 0
        for color in np.unique(labels_c):
            lab, n = ndimage.label(labels_c == color)
            comp = np.where(lab > 0, lab + n_total, comp)
            n_total += n
        _, comp = np.unique(comp, return_inverse=True)
        comp = comp.reshape(h, w)

        results = []
        for cid, area in zip(*np.unique(comp, return_counts=True)):
            if area < self.min_area:
                continue
            seg = comp == cid
            ys, xs = np.nonzero(seg)
            bbox_area = (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1)
            compactness = float(area) / float(bbox_area)
            results.append({
                "segmentation": seg,
                "predicted_iou": 0.86 + 0.13 * min(compactness, 1.0),
                "area": int(area),
                # Same result schema as the SAM backend (XYWH bbox,
                # full-image crop) so consumers never branch on backend.
                "bbox": [int(xs.min()), int(ys.min()),
                         int(xs.max() - xs.min()), int(ys.max() - ys.min())],
                "stability_score": float(compactness),
                "point_coords": [],
                "crop_box": [0, 0, w, h],
            })
        results.sort(key=lambda r: -r["area"])
        return results


def object_segment_image(sam, detector, auto_mask=None
                         ) -> Callable[[np.ndarray], List[Dict]]:
    """The reference's ``object_segment_image`` path as a backend: the
    detector's boxes prompt SAM; with no box, SAM's point-grid masks
    under ``auto_mask`` (an ``AutoMaskConfig``, its defaults if None)."""
    def backend(image):
        boxes, confs = detector(image)
        if len(boxes) == 0:
            return sam.auto_segment(image) if auto_mask is None \
                else sam.auto_segment(image, auto_mask)
        return sam.segment_boxes(image, boxes, confs)

    return backend


class Segmentation:
    """Facade over the available mask generator (the reference's
    Segmentation): ``auto_segment_image`` -> SAM-style results,
    ``composite`` -> merged id map.  Without a ``backend`` it picks, as the
    JAX package does, YOLO boxes + SAM when both converted checkpoints are
    found, SAM's point grid with SAM alone, else the classical segmenter;
    the SAM and YOLO towers run on ``device`` (the card by default).
    ``sam_model`` names SAM's encoder (``sam_predictor.SAM_ENCODERS``; its
    ``sam_<model>.npz`` is looked for and checked, ``sam_vit_b.npz`` as it
    is without a name), ``auto_mask`` the point grid's settings (an
    ``AutoMaskConfig``).  ``sam`` is the SAM backend it built, if any."""

    def __init__(self, backend: Optional[object] = None, device=None,
                 sam_model: Optional[str] = None, auto_mask=None):
        self.sam = None
        if backend is None:
            from .sam_predictor import SamBackend, sam_available
            from .yolo import ObjectAwareDetector, yolo_available

            if sam_available(sam_model):
                self.sam = SamBackend(device=device, model=sam_model)
            if self.sam is not None and yolo_available():
                backend = object_segment_image(
                    self.sam, ObjectAwareDetector(device=device), auto_mask)
            elif self.sam is not None:
                backend = functools.partial(self.sam.auto_segment,
                                            config=auto_mask)
            else:
                backend = FelzenszwalbLiteSegmenter()
        self.backend = backend

    def auto_segment_image(self, image: np.ndarray) -> List[Dict]:
        return self.backend(image)

    def composite(self, image: np.ndarray,
                  confidence_threshold: float = 0.85) -> np.ndarray:
        results = self.auto_segment_image(image)
        if not results:
            return np.zeros(np.asarray(image).shape[:2], np.uint8)
        return create_composite_mask(results, confidence_threshold)

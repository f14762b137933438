"""SAM predictor and automatic mask generation over the SAM modules.

Counterpart of the JAX package's ``features/sam_predictor.py``, which
mirrors the reference's two segmentation entry points:

* :meth:`SamBackend.segment_boxes`: box-prompted segmentation (the
  MobileSAMv2 + detector path), in batches of 64 boxes;
* :meth:`SamBackend.auto_segment`: point-grid automatic masks
  (``SamAutomaticMaskGenerator``) under one :class:`AutoMaskConfig`: a
  grid of foreground points, multimask output, filtering by predicted IoU
  and stability on the 256x256 logits, then greedy mask NMS, all on the
  backend's device; only the kept masks and their numbers reach the host.

A backend names its model (``"vit_b"``, ``"vit_l"``, ``"vit_h"``: SAM's
three released encoders, :data:`SAM_ENCODERS`), finds ``sam_<model>.npz``,
refuses a file whose encoder has other sizes and runs the decoder as SAM
does (its two-way transformer's LayerNorms at eps 1e-5); without a name it
takes ``sam_vit_b.npz`` at whatever sizes the file holds and runs the
decoder as the JAX package does (eps 1e-6).

The towers run on the backend's ``device`` (the card unless the caller
passes ``device="cpu"``); results come back to the host in the reference's
dict format (segmentation, area, bbox, predicted_iou, stability_score),
which ``features/grouping.py`` consumes.

Spans (``utils/profiling.py``): ``sam.image`` (one ``auto_segment``),
``sam.encode`` (``set_image``), ``sam.decode`` (one prompt batch),
``sam.filter`` (the automatic masks' filter and NMS), ``sync.sam`` (each
read of the host); counters ``sam.prompts``, ``sam.masks``,
``sam.candidates`` (masks past IoU, stability and ``min_area``) and
``sam.kept``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from ..utils.device import resolve_device
from . import sam as S
from .decoder import resize_bilinear
from .vit import load_params
from .weights import find_weights

_MEAN = (123.675, 116.28, 103.53)
_STD = (58.395, 57.12, 57.375)
# Survivors of the quality filter are upscaled this many at a time.
_UPSCALE_BATCH = 32


class EncoderSpec(NamedTuple):
    dim: int
    depth: int
    num_heads: int
    global_blocks: Tuple[int, ...]
    window: int = 14


# SAM's released image encoders (segment_anything/build_sam.py).
SAM_ENCODERS: Dict[str, EncoderSpec] = {
    "vit_b": EncoderSpec(768, 12, 12, (2, 5, 8, 11)),
    "vit_l": EncoderSpec(1024, 24, 16, (5, 11, 17, 23)),
    "vit_h": EncoderSpec(1280, 32, 16, (7, 15, 23, 31)),
}


@dataclasses.dataclass(frozen=True)
class AutoMaskConfig:
    """The settings of :meth:`SamBackend.auto_segment`: a grid of
    ``points_per_side`` squared prompts decoded ``points_per_batch`` at a
    time, masks kept where the predicted IoU and the stability score (at
    ``stability_offset`` around logit 0) reach their thresholds and the
    upscaled area reaches ``min_area``, then greedy NMS at mask IoU
    ``nms_iou``.  SAM's published automatic settings are 32, 64, 0.88,
    1.0, 0.95 and 0.7."""

    points_per_side: int = 16
    points_per_batch: int = 64
    pred_iou_thresh: float = 0.7
    stability_offset: float = 1.0
    stability_thresh: float = 0.85
    nms_iou: float = 0.7
    min_area: int = 64


def _weights_file(model: Optional[str]) -> str:
    return f"sam_{model or 'vit_b'}.npz"


def sam_available(model: Optional[str] = None) -> bool:
    return find_weights(_weights_file(model)) is not None


def check_encoder(arrays: Mapping, model: str) -> None:
    """Raise unless the weights' ``enc.*`` sizes are those of the named
    model; a decoder-only file passes."""
    if model not in SAM_ENCODERS:
        raise ValueError(f"unknown SAM model {model!r}; the port knows "
                         f"{sorted(SAM_ENCODERS)}")
    if "enc.patch_embed.w" not in arrays:
        return
    want = SAM_ENCODERS[model]
    got = EncoderSpec(
        int(arrays["enc.patch_embed.w"].shape[1]),
        int(arrays["enc.n_blocks"]), int(arrays["enc.num_heads"]),
        tuple(int(i) for i in np.asarray(arrays["enc.global_blocks"])),
        int(arrays["enc.window"]))
    if got != want:
        raise ValueError(f"the weights' encoder is {got}, not {model}'s "
                         f"{want}")


class SamBackend:
    """Stateful predictor (one ``set_image``, many prompts), as
    SamPredictor."""

    def __init__(self, weights_npz: Optional[str] = None, device=None,
                 model: Optional[str] = None):
        """``model`` names the encoder the file must hold (a key of
        :data:`SAM_ENCODERS`); without it the file is taken as it is."""
        name = _weights_file(model)
        path = weights_npz or find_weights(name)
        if path is None:
            raise RuntimeError(
                "SAM weights not found: convert a segment-anything "
                "checkpoint with scripts/convert_sam.py and place "
                f"{name} under weights/."
            )
        self.device = resolve_device(device)
        self.model = model
        self._ln_eps = 1e-6 if model is None else S.DECODER_LN_EPS
        if model is not None:
            with np.load(path) as data:
                check_encoder(data, model)
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
        with profiling.span("sam.encode"):
            self._set_image(image, embedding)

    def _set_image(self, image, embedding) -> None:
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
                                      sparse, multimask=multimask,
                                      ln_eps=self._ln_eps)

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
        upscaled: quality filtering runs at this resolution, so only the
        survivors pay the resize."""
        low, iou = self._decode_points(points, multimask)
        return low.cpu().numpy(), iou.cpu().numpy()

    def _decode_points(self, points: np.ndarray, multimask: bool):
        """:meth:`predict_points_low` on the device."""
        assert self._embedding is not None, "call set_image first"
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.device)[:, None, :] * self._scale
        labels = torch.ones(pts.shape[:2], dtype=torch.int32,
                            device=self.device)
        return self._decode(S.encode_points(self.params, pts, labels),
                            multimask)

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

    @torch.no_grad()
    def auto_segment(self, image: np.ndarray,
                     config: Optional[AutoMaskConfig] = None) -> List[Dict]:
        """Point-grid automatic masks (SamAutomaticMaskGenerator's rules:
        multimask per point, IoU and stability filtering, greedy mask NMS
        by predicted IoU) under ``config`` (:class:`AutoMaskConfig`'s
        defaults without one).  Every step runs on the backend's device;
        the host reads twice: which masks pass the quality filter, then
        the kept masks with their numbers."""
        cfg = config or AutoMaskConfig()
        with profiling.span("sam.image"):
            self.set_image(image)
            h, w = image.shape[:2]
            n = cfg.points_per_side
            g = (np.arange(n) + 0.5) / n
            pts = np.stack(np.meshgrid(g * w, g * h), axis=-1).reshape(-1, 2)
            lows, ious = [], []
            for s0 in range(0, len(pts), cfg.points_per_batch):
                with profiling.span("sam.decode"):
                    low, iou = self._decode_points(
                        pts[s0 : s0 + cfg.points_per_batch], True)
                lows.append(low)
                ious.append(iou)
            profiling.count("sam.prompts", len(pts))
            profiling.count("sam.masks", sum(x.shape[0] * x.shape[1]
                                             for x in ious))
            with profiling.span("sam.filter"):
                return filter_masks(lows, ious, pts, cfg, self._orig_hw,
                                    self._input_hw)


def _stability(low: torch.Tensor, offset: float) -> torch.Tensor:
    """[B, M] stability scores of [B, M, 256, 256] logits, in float64: the
    pixels above ``offset`` over those above ``-offset`` (at least 1)."""
    inter = (low > offset).sum(dim=(2, 3)).double()
    union = (low > -offset).sum(dim=(2, 3)).double()
    return inter / torch.clamp(union, min=1.0)


def filter_masks(lows: List[torch.Tensor], ious: List[torch.Tensor],
                 pts: np.ndarray, cfg: AutoMaskConfig,
                 orig_hw: Tuple[int, int], input_hw: Tuple[int, int]
                 ) -> List[Dict]:
    """The automatic masks of a point grid ``pts`` from its prompt
    batches' [B, M, 256, 256] logits and [B, M] predicted IoUs, on their
    device, deciding as a host loop over the masks would: predicted IoU,
    then the stability score on each logit map (counts and ratio in
    float64, as Python's floats), survivors upscaled ``_UPSCALE_BATCH`` at
    a time, the ``min_area`` cut, greedy NMS in descending predicted IoU
    (a stable sort, so ties keep the prompts' order) over the pairwise
    intersections, one float32 product of {0, 1} masks (exact: every count
    is below 2**24), and the boxes.  The host reads twice: which masks
    pass the quality filter, then the kept masks and their numbers."""
    dev = lows[0].device
    h, w = orig_hw
    iou = torch.cat(ious).double()                          # [P, M]
    m = iou.shape[1]
    stab = torch.cat([_stability(x, cfg.stability_offset) for x in lows])
    passed = ~(iou < cfg.pred_iou_thresh) & ~(stab < cfg.stability_thresh)
    with profiling.span("sync.sam"):
        flat = np.flatnonzero(passed.cpu().numpy())
    if len(flat) == 0:
        profiling.count("sam.candidates", 0)
        profiling.count("sam.kept", 0)
        return []
    b = lows[0].shape[0]
    # The survivors' logits, in the prompts' order.
    surv = []
    for bi, low in enumerate(lows):
        sel = flat[(flat >= bi * b * m) & (flat < (bi + 1) * b * m)]
        if len(sel):
            idx = torch.as_tensor(sel - bi * b * m, device=dev)
            surv.append(low.flatten(0, 1)[idx])
    surv = torch.cat(surv)                                  # [S, 256, 256]
    n = surv.shape[0]
    masks = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    for s0 in range(0, n, _UPSCALE_BATCH):
        up = S.postprocess_masks(surv[s0 : s0 + _UPSCALE_BATCH, None],
                                 orig_hw, input_hw)
        masks[s0 : s0 + _UPSCALE_BATCH] = up[:, 0] > 0.0
    del surv
    area = masks.sum(dim=(1, 2))                            # [S] int64
    cand = ~(area < cfg.min_area)
    profiling.count("sam.candidates", cand.sum())
    sel = torch.as_tensor(flat, device=dev)
    s_iou = iou.flatten()[sel]
    order = torch.sort(-s_iou, stable=True).indices
    flat_m = masks.reshape(n, -1).to(torch.float32)
    inter = (flat_m @ flat_m.T)[order][:, order].double()
    del flat_m
    a = area[order].double()
    union = a[:, None] + a[None, :] - inter
    sup = torch.tril((union > 0) & (inter / union > cfg.nms_iou), -1)
    keep = cand[order].clone()
    for i in range(n):
        keep[i] &= ~torch.any(sup[i] & keep)
    rows, cols = masks.any(dim=2), masks.any(dim=1)
    y0 = torch.argmax(rows.to(torch.uint8), dim=1)
    y1 = h - 1 - torch.argmax(rows.flip(1).to(torch.uint8), dim=1)
    x0 = torch.argmax(cols.to(torch.uint8), dim=1)
    x1 = w - 1 - torch.argmax(cols.flip(1).to(torch.uint8), dim=1)
    nums = torch.stack([s_iou, stab.flatten()[sel], area.double(),
                        x0.double(), y0.double(), (x1 - x0).double(),
                        (y1 - y0).double()], dim=1)
    with profiling.span("sync.sam"):
        kept = order[torch.nonzero(keep).flatten()]
        nums = nums[kept].cpu().numpy()
        segs = masks[kept].cpu().numpy()
        kept = kept.cpu().numpy()
    profiling.count("sam.kept", len(kept))
    return [{
        "segmentation": seg, "area": int(num[2]),
        "predicted_iou": float(num[0]), "stability_score": float(num[1]),
        "point_coords": [pts[flat[j] // m].tolist()],
        "crop_box": [0, 0, w, h],
        "bbox": [int(v) for v in num[3:]],
    } for j, seg, num in zip(kept, segs, nums)]

"""YOLOv8 object detector: the box-prompt source for MobileSAMv2.

Counterpart of the JAX package's ``features/yolo.py``: the YOLOv8 *detect*
architecture (ultralytics v8, anchor-free decoupled head) on the weights
``scripts/convert_yolo.py`` writes (each conv with its BatchNorm fused,
HWIO, under its module index).  Every width, C2f repeat count and the
number of classes come from the weight shapes, so one forward serves the
n/s/m/l/x scales.

* backbone: a stem conv, four stages of stride-2 conv + C2f, SPPF;
* neck: PAN, two top-down upsample/concat/C2f stages and two bottom-up
  stride-2-conv/concat/C2f stages;
* head: per level (P3/P4/P5) a box branch to 4 * 16 DFL logits and a
  class branch; the DFL softmax gives the l/t/r/b distances, scaled by the
  level's stride around the cell centres; class scores through a sigmoid;
* class-agnostic greedy NMS on the host (``nms_boxes``, numpy as in JAX).

JAX works in NHWC; this module runs the convolutions in NCHW
(``F.conv2d``, TF32 off) and takes and returns JAX's layouts at its
boundary.  The detector runs on its ``device``, the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .decoder import resize_bilinear
from .vit import load_params
from .weights import find_weights

STRIDES = (8, 16, 32)
IMG_SIZE = 640  # ultralytics default imgsz; inputs are letterboxed to this
REG_MAX = 16
Params = Dict[str, torch.Tensor]


def yolo_available() -> bool:
    return find_weights("yolov8_objaware.npz") is not None


# --------------------------------------------------------------- primitives


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
          act: bool = True) -> torch.Tensor:
    """Conv on [1, C, H, W] with an HWIO weight, SAME padding, the fused
    BatchNorm's bias, SiLU."""
    y = F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride,
                 padding=(w.shape[0] - 1) // 2)
    return F.silu(y) if act else y


def _cbs(p: Params, pre: str, x: torch.Tensor, stride: int = 1):
    return _conv(x, p[f"{pre}.w"], p[f"{pre}.b"], stride)


def _n_bottlenecks(p: Params, pre: str) -> int:
    n = 0
    while f"{pre}.m.{n}.cv1.w" in p:
        n += 1
    return n


def _c2f(p: Params, pre: str, x: torch.Tensor, shortcut: bool):
    y = _cbs(p, f"{pre}.cv1", x)
    a, cur = y.chunk(2, dim=1)
    outs = [a, cur]
    for j in range(_n_bottlenecks(p, pre)):
        h = _cbs(p, f"{pre}.m.{j}.cv2", _cbs(p, f"{pre}.m.{j}.cv1", cur))
        cur = cur + h if shortcut else h
        outs.append(cur)
    return _cbs(p, f"{pre}.cv2", torch.cat(outs, dim=1))


def _sppf(p: Params, pre: str, x: torch.Tensor):
    y = _cbs(p, f"{pre}.cv1", x)
    # max_pool2d pads with -inf, as JAX's reduce_window does here.
    m1 = F.max_pool2d(y, 5, 1, 2)
    m2 = F.max_pool2d(m1, 5, 1, 2)
    m3 = F.max_pool2d(m2, 5, 1, 2)
    return _cbs(p, f"{pre}.cv2", torch.cat([y, m1, m2, m3], dim=1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour upsampling by 2."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


# ------------------------------------------------------------------ forward


def yolo_forward(p: Params, img: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[H, W, 3] float image in [0, 1] (H, W multiples of 32) ->
    (boxes_xyxy [A, 4] in input pixels, class scores [A, nc])."""
    x = img.permute(2, 0, 1)[None]
    x = _cbs(p, "0", x, stride=2)
    x = _cbs(p, "1", x, stride=2)
    x = _c2f(p, "2", x, shortcut=True)
    x = _cbs(p, "3", x, stride=2)
    x4 = _c2f(p, "4", x, shortcut=True)            # P3 skip
    x = _cbs(p, "5", x4, stride=2)
    x6 = _c2f(p, "6", x, shortcut=True)            # P4 skip
    x = _cbs(p, "7", x6, stride=2)
    x = _c2f(p, "8", x, shortcut=True)
    x9 = _sppf(p, "9", x)                          # P5

    # PAN neck.
    x12 = _c2f(p, "12", torch.cat([_upsample2(x9), x6], dim=1),
               shortcut=False)
    x15 = _c2f(p, "15", torch.cat([_upsample2(x12), x4], dim=1),
               shortcut=False)                     # P3 out
    x18 = _c2f(p, "18", torch.cat([_cbs(p, "16", x15, 2), x12], dim=1),
               shortcut=False)                     # P4 out
    x21 = _c2f(p, "21", torch.cat([_cbs(p, "19", x18, 2), x9], dim=1),
               shortcut=False)                     # P5 out

    bins = torch.arange(REG_MAX, dtype=torch.float32, device=img.device)
    boxes_all: List[torch.Tensor] = []
    scores_all: List[torch.Tensor] = []
    for lvl, (feat, stride) in enumerate(zip((x15, x18, x21), STRIDES)):
        bx, cl = feat, feat
        for j in (0, 1):
            bx = _cbs(p, f"22.cv2.{lvl}.{j}", bx)
            cl = _cbs(p, f"22.cv3.{lvl}.{j}", cl)
        bx = _conv(bx, p[f"22.cv2.{lvl}.2.w"], p[f"22.cv2.{lvl}.2.b"],
                   act=False)[0]                   # [4 * reg_max, h, w]
        cl = _conv(cl, p[f"22.cv3.{lvl}.2.w"], p[f"22.cv3.{lvl}.2.b"],
                   act=False)[0]                   # [nc, h, w]
        _, h, w = bx.shape
        dfl = torch.softmax(bx.permute(1, 2, 0).reshape(h * w, 4, REG_MAX),
                            dim=-1)
        dist = dfl @ bins                          # [hw, 4] l, t, r, b
        cx = torch.arange(w, dtype=torch.float32, device=img.device
                          ).repeat(h) + 0.5
        cy = torch.arange(h, dtype=torch.float32, device=img.device
                          ).repeat_interleave(w) + 0.5
        boxes_all.append(torch.stack([
            (cx - dist[:, 0]) * stride, (cy - dist[:, 1]) * stride,
            (cx + dist[:, 2]) * stride, (cy + dist[:, 3]) * stride], dim=-1))
        scores_all.append(torch.sigmoid(cl.permute(1, 2, 0).reshape(h * w,
                                                                     -1)))
    return torch.cat(boxes_all), torch.cat(scores_all)


# ---------------------------------------------------------------- detector


def nms_boxes(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float,
              max_det: int) -> np.ndarray:
    """Class-agnostic greedy NMS; returns kept indices (score-descending)."""
    order = np.argsort(-scores)
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    keep: List[int] = []
    while order.size and len(keep) < max_det:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        ix1 = np.maximum(x1[i], x1[rest])
        iy1 = np.maximum(y1[i], y1[rest])
        ix2 = np.minimum(x2[i], x2[rest])
        iy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, np.int64)


class ObjectAwareDetector:
    """Box-proposal detector (the reference's ObjAwareModel role):
    ``__call__(image) -> (boxes_xyxy [K, 4] in image pixels, conf [K])``
    with the reference's thresholds."""

    def __init__(self, weights_npz: Optional[str] = None,
                 conf: float = 0.25, iou: float = 0.5, max_det: int = 300,
                 device=None):
        path = weights_npz or find_weights("yolov8_objaware.npz")
        if path is None:
            raise RuntimeError(
                "YOLO weights not found: convert an ultralytics/MobileSAMV2 "
                "ObjectAwareModel checkpoint with scripts/convert_yolo.py "
                "and place yolov8_objaware.npz under weights/."
            )
        self.device = resolve_device(device)
        self.params = load_params(path, self.device)
        self.conf = conf
        self.iou = iou
        self.max_det = max_det

    @torch.no_grad()
    def letterbox(self, image: np.ndarray) -> Tuple[torch.Tensor, float]:
        """The image in [0, 1], its long edge resized to 640 and padded with
        grey to multiples of 32 (on the detector's device), and the scale."""
        img = np.asarray(image, np.float32)
        if img.max() > 1.0 + 1e-6:
            img = img / 255.0
        h, w = img.shape[:2]
        scale = IMG_SIZE / max(h, w)
        th, tw = int(round(h * scale)), int(round(w * scale))
        resized = resize_bilinear(torch.as_tensor(img, device=self.device),
                                  (th, tw))
        padded = torch.full((-(-th // 32) * 32, -(-tw // 32) * 32, 3), 0.447,
                            device=self.device)
        padded[:th, :tw] = resized
        return padded, scale

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        h, w = np.asarray(image).shape[:2]
        padded, scale = self.letterbox(image)
        boxes, scores = yolo_forward(self.params, padded)
        boxes = boxes.cpu().numpy()
        confs = scores.max(dim=1).values.cpu().numpy()
        sel = confs >= self.conf
        boxes, confs = boxes[sel], confs[sel]
        if len(boxes) == 0:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
        keep = nms_boxes(boxes, confs, self.iou, self.max_det)
        boxes, confs = boxes[keep] / scale, confs[keep]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w - 1)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h - 1)
        return boxes.astype(np.float32), confs.astype(np.float32)

"""Plain reference of the YOLOv8 detect model as MobileSAMv2's object-aware
box prompter runs it: seeded weights, the letterbox, the forward, the
anchor-free decode and class-agnostic greedy NMS.

Plain PyTorch, float32, no kernel, no cache and no batching across images;
it imports nothing of the program.  It is written from ultralytics'
``ultralytics/cfg/models/v8/yolov8.yaml`` and ``nn/modules/{conv,block,
head}.py`` (Jocher et al., YOLOv8), on weights in the layout of
``scripts/convert_yolo.py`` (each convolution with its BatchNorm folded
into weight and bias, HWIO, under its module index):

* ``Conv``: a k x k convolution (padding k // 2) plus bias, then SiLU;
* ``C2f``: a 1x1 convolution to twice the hidden width, split in two, n
  bottlenecks (two 3x3 convolutions, a residual in the backbone), every
  part concatenated and a 1x1 convolution;
* ``SPPF``: a 1x1 convolution to half the width, three 5x5 stride-1 max
  pools in a row, the four maps concatenated and a 1x1 convolution;
* the PAN neck: nearest-neighbour upsampling by 2 and concatenation top
  down, stride-2 convolutions and concatenation bottom up;
* ``Detect``: per level (strides 8, 16, 32) a box branch (two 3x3 Conv,
  a 1x1 convolution to 4 x ``reg_max`` logits) and a class branch (the
  same to ``nc`` logits); the DFL is a softmax over each side's
  ``reg_max`` bins and its expectation, the distances l, t, r, b from the
  cell centre (x + 0.5, y + 0.5) times the stride; scores a sigmoid;
* class-agnostic greedy NMS: the highest score first, every box whose IoU
  with it passes the threshold dropped, at most ``max_det`` kept.

Departures from ultralytics, each as the program has it:

* the letterbox resizes the long edge to ``imgsz`` with an antialiased
  bilinear filter in float32 (ultralytics: ``cv2.resize`` linear on
  uint8) and pads at the bottom and right to multiples of ``pad`` with
  ``pad_value`` (ultralytics centres the image and pads both sides with
  114 / 255); pixels over 1 are divided by 255;
* the NMS is class-agnostic, on the boxes of the letterbox, and its
  suppression is strict (IoU over the threshold), as
  ``torchvision.ops.nms``; the kept boxes are scaled back and clipped to
  the image, without ultralytics' shift for the centring;
* MobileSAMv2's release has one class and a mask-prototype branch whose
  output the box prompter never reads: it is not built.

``Products(tf32=True)`` rounds every operand of a convolution to TF32: the
control one precision below the float32 the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .precision import Products

Params = Dict[str, torch.Tensor]


class Spec(NamedTuple):
    """A detect model's sizes, as a configuration file states them."""

    widths: Tuple[int, ...]          # layers 0, 1, 3, 5, 7
    backbone_repeats: Tuple[int, ...]  # C2f 2, 4, 6, 8
    neck_repeats: Tuple[int, ...]    # C2f 12, 15, 18, 21
    box_branch: int
    class_branch: int
    nc: int = 1
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    sppf_k: int = 5


def spec(det: dict) -> Spec:
    """The :class:`Spec` of a configuration file's ``detector`` block."""
    return Spec(tuple(det["widths"]), tuple(det["backbone_repeats"]),
                tuple(det["neck_repeats"]), det["box_branch"],
                det["class_branch"], det["nc"], det["reg_max"],
                tuple(det["strides"]), det["sppf_k"])


# ----------------------------------------------------------------- weights
def shapes(s: Spec) -> Dict[str, Tuple[int, ...]]:
    """Every weight's shape (HWIO) and bias, in the converter's layout."""
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(pre, cin, cout, k):
        out[f"{pre}.w"], out[f"{pre}.b"] = (k, k, cin, cout), (cout,)

    def c2f(pre, cin, cout, n):
        c = cout // 2
        conv(f"{pre}.cv1", cin, 2 * c, 1)
        for j in range(n):
            conv(f"{pre}.m.{j}.cv1", c, c, 3)
            conv(f"{pre}.m.{j}.cv2", c, c, 3)
        conv(f"{pre}.cv2", (2 + n) * c, cout, 1)

    c0, c1, c2, c3, c4 = s.widths
    b, n = s.backbone_repeats, s.neck_repeats
    conv("0", 3, c0, 3)
    conv("1", c0, c1, 3)
    c2f("2", c1, c1, b[0])
    conv("3", c1, c2, 3)
    c2f("4", c2, c2, b[1])
    conv("5", c2, c3, 3)
    c2f("6", c3, c3, b[2])
    conv("7", c3, c4, 3)
    c2f("8", c4, c4, b[3])
    conv("9.cv1", c4, c4 // 2, 1)
    conv("9.cv2", c4 // 2 * 4, c4, 1)
    c2f("12", c4 + c3, c3, n[0])
    c2f("15", c3 + c2, c2, n[1])
    conv("16", c2, c2, 3)
    c2f("18", c2 + c3, c3, n[2])
    conv("19", c3, c3, 3)
    c2f("21", c3 + c4, c4, n[3])
    for lvl, cin in enumerate((c2, c3, c4)):
        for br, mid, last in (("cv2", s.box_branch, 4 * s.reg_max),
                              ("cv3", s.class_branch, s.nc)):
            conv(f"22.{br}.{lvl}.0", cin, mid, 3)
            conv(f"22.{br}.{lvl}.1", mid, mid, 3)
            conv(f"22.{br}.{lvl}.2", mid, last, 1)
    return out


# The box branch's last convolution is drawn this much below 1 / fan_in,
# so that each side's DFL distribution is broad (boxes about 15 strides
# across) and the boxes' sizes, and with them how many boxes NMS keeps,
# depend little on the frame.
BOX_GAIN = 0.3


def init_params(s: Spec, generator: torch.Generator, device,
                images: torch.Tensor) -> Params:
    """Seeded folded weights: each convolution drawn normal, then, as a
    BatchNorm at its running statistics folds into it, scaled and shifted
    so that its outputs over the letterboxed ``images`` [N, H, W, 3] have
    zero mean and unit variance per channel; the head's last convolutions
    keep their draw of variance 1 / fan_in (the box branch's
    ``BOX_GAIN ** 2 / fan_in``) and zero biases."""
    p: Params = {}
    for k, shape in shapes(s).items():
        if k.endswith(".w"):
            fan = shape[0] * shape[1] * shape[2]
            gain = BOX_GAIN if k.startswith("22.cv2.") and \
                k.endswith(".2.w") else 1.0
            p[k] = torch.randn(shape, generator=generator, device=device) \
                * (gain / math.sqrt(fan))
        else:
            p[k] = torch.zeros(shape, device=device)
    with torch.no_grad():
        forward(p, s, images, Products(False), fold=set())
    return p


def parameter_count(p: Params) -> int:
    return sum(t.numel() for t in p.values())


# ------------------------------------------------------------------ layers
def conv(x: torch.Tensor, p: Params, pre: str, prec: Products,
         stride: int = 1, act: bool = True, fold=None) -> torch.Tensor:
    """[N, C, H, W] -> the module ``pre``'s convolution (k // 2 padding),
    bias and SiLU.  With ``fold`` (a set of the modules done), a module
    met for the first time is first normalised over ``x`` in place (see
    :func:`init_params`)."""
    w = p[f"{pre}.w"]

    def run():
        return F.conv2d(prec._r(x), prec._r(w.permute(3, 2, 0, 1)),
                        p[f"{pre}.b"], stride=stride,
                        padding=w.shape[0] // 2)

    y = run()
    if fold is not None and act and pre not in fold:
        fold.add(pre)
        mean = y.mean(dim=(0, 2, 3))
        std = y.std(dim=(0, 2, 3)).clamp(min=1e-6)
        w /= std
        p[f"{pre}.b"] = (p[f"{pre}.b"] - mean) / std
        y = run()
    return F.silu(y) if act else y


def c2f(x, p: Params, pre: str, n: int, shortcut: bool, prec: Products,
        fold=None):
    y = conv(x, p, f"{pre}.cv1", prec, fold=fold)
    c = y.shape[1] // 2
    parts = [y[:, :c], y[:, c:]]
    for j in range(n):
        h = conv(conv(parts[-1], p, f"{pre}.m.{j}.cv1", prec, fold=fold), p,
                 f"{pre}.m.{j}.cv2", prec, fold=fold)
        parts.append(parts[-1] + h if shortcut else h)
    return conv(torch.cat(parts, 1), p, f"{pre}.cv2", prec, fold=fold)


def sppf(x, p: Params, pre: str, k: int, prec: Products, fold=None):
    y = conv(x, p, f"{pre}.cv1", prec, fold=fold)
    pools = [y]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], k, 1, k // 2))
    return conv(torch.cat(pools, 1), p, f"{pre}.cv2", prec, fold=fold)


def upsample(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ----------------------------------------------------------------- forward
def forward(p: Params, s: Spec, img: torch.Tensor, prec: Products,
            fold=None, centre: float = 0.5
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[H, W, 3] letterboxed image in [0, 1] -> (boxes [A, 4] x1 y1 x2 y2
    in its pixels, class logits [A, nc]); anchors level by level, row by
    row.  ``fold``: :func:`conv`'s, over a batch [N, H, W, 3] (the
    outputs are then the first image's).  Another ``centre`` than 0.5
    puts the anchors off the cells' centres: a fault for the check."""
    b, n = s.backbone_repeats, s.neck_repeats

    def cv(x, pre, stride=1):
        return conv(x, p, pre, prec, stride, fold=fold)

    def cf(x, pre, reps, shortcut):
        return c2f(x, p, pre, reps, shortcut, prec, fold)

    x = cv((img if img.dim() == 4 else img[None]).permute(0, 3, 1, 2),
           "0", 2)
    x = cv(x, "1", 2)
    x = cf(x, "2", b[0], True)
    x = cv(x, "3", 2)
    p3 = cf(x, "4", b[1], True)
    x = cv(p3, "5", 2)
    p4 = cf(x, "6", b[2], True)
    x = cv(p4, "7", 2)
    x = cf(x, "8", b[3], True)
    p5 = sppf(x, p, "9", s.sppf_k, prec, fold)
    h12 = cf(torch.cat([upsample(p5), p4], 1), "12", n[0], False)
    o3 = cf(torch.cat([upsample(h12), p3], 1), "15", n[1], False)
    o4 = cf(torch.cat([cv(o3, "16", 2), h12], 1), "18", n[2], False)
    o5 = cf(torch.cat([cv(o4, "19", 2), p5], 1), "21", n[3], False)
    boxes, logits = [], []
    bins = torch.arange(s.reg_max, dtype=torch.float32, device=img.device)
    for lvl, (feat, stride) in enumerate(zip((o3, o4, o5), s.strides)):
        bx, cl = feat, feat
        for j in (0, 1):
            bx = cv(bx, f"22.cv2.{lvl}.{j}")
            cl = cv(cl, f"22.cv3.{lvl}.{j}")
        bx = conv(bx, p, f"22.cv2.{lvl}.2", prec, act=False)[0]
        cl = conv(cl, p, f"22.cv3.{lvl}.2", prec, act=False)[0]
        _, h, w = bx.shape
        dist = torch.softmax(bx.reshape(4, s.reg_max, h * w), dim=1)
        dist = (dist * bins[None, :, None]).sum(dim=1)       # [4, hw]
        cy, cx = torch.meshgrid(torch.arange(h, device=img.device),
                                torch.arange(w, device=img.device),
                                indexing="ij")
        cx = cx.reshape(-1).float() + centre
        cy = cy.reshape(-1).float() + centre
        boxes.append(torch.stack([cx - dist[0], cy - dist[1],
                                  cx + dist[2], cy + dist[3]], 1) * stride)
        logits.append(cl.reshape(s.nc, h * w).T)
    return torch.cat(boxes), torch.cat(logits)


def letterbox(image: torch.Tensor, imgsz: int, pad: int, value: float
              ) -> Tuple[torch.Tensor, float]:
    """[H, W, 3] pixels -> (the [H', W', 3] letterboxed image in [0, 1],
    the scale)."""
    img = image.float()
    if float(img.max()) > 1.0 + 1e-6:
        img = img / 255.0
    h, w = img.shape[:2]
    scale = imgsz / max(h, w)
    th, tw = int(round(h * scale)), int(round(w * scale))
    x = F.interpolate(img.permute(2, 0, 1)[None], size=(th, tw),
                      mode="bilinear", align_corners=False,
                      antialias=True)[0].permute(1, 2, 0)
    out = torch.full((-(-th // pad) * pad, -(-tw // pad) * pad, 3), value,
                     device=img.device)
    out[:th, :tw] = x
    return out, scale


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou: float,
        max_det: int) -> torch.Tensor:
    """Class-agnostic greedy NMS over [N, 4] boxes: the kept indices, by
    descending score (IoUs in float64)."""
    order = torch.argsort(scores, descending=True)
    b = boxes.double()
    area = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    keep = []
    while len(order) and len(keep) < max_det:
        i, rest = order[0], order[1:]
        keep.append(i)
        lo = torch.maximum(b[i, :2], b[rest, :2])
        hi = torch.minimum(b[i, 2:], b[rest, 2:])
        inter = (hi - lo).clamp(min=0).prod(dim=1)
        ov = inter / (area[i] + area[rest] - inter).clamp(min=1e-9)
        order = rest[ov <= iou]
    return torch.stack(keep) if keep else order


class Detections(NamedTuple):
    boxes: torch.Tensor     # [A, 4] raw, letterbox pixels
    scores: torch.Tensor    # [A] the best class's sigmoid
    kept: torch.Tensor      # [K, 4] kept boxes in image pixels
    confs: torch.Tensor     # [K]


def detect(p: Params, s: Spec, image: torch.Tensor, det: dict,
           prec: Products, centre: float = 0.5) -> Detections:
    """The box prompter on one [H, W, 3] image under a configuration's
    ``detector`` settings (imgsz, pad_multiple, pad_value, conf, iou,
    max_det); ``centre``: :func:`forward`'s."""
    h, w = image.shape[:2]
    with torch.no_grad():
        img, scale = letterbox(image, det["imgsz"], det["pad_multiple"],
                               det["pad_value"])
        boxes, logits = forward(p, s, img, prec, centre=centre)
        scores = torch.sigmoid(logits).amax(dim=1)
        sel = torch.nonzero(scores >= det["conf"]).flatten()
        idx = sel[nms(boxes[sel], scores[sel], det["iou"], det["max_det"])]
        kept = boxes[idx] / scale
        kept[:, 0::2] = kept[:, 0::2].clamp(0, w - 1)
        kept[:, 1::2] = kept[:, 1::2].clamp(0, h - 1)
    return Detections(boxes, scores, kept, scores[idx])


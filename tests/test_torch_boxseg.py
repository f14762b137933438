"""MobileSAMv2's object-aware path in the port, on the CPU: the YOLOv8
detector and box-prompted SAM through ``Segmentation`` against the
benchmark's plain references (``benchmark/reference/yolo.py`` and
``boxseg.py``, loaded by path) on seeded weights at YOLOv8n's widths and a
tiny SAM; the device-side ``segment_boxes`` against the host loop it
replaced, dict for dict; ``YOLO_SCALES`` refusing a file of other widths;
the object path's spans and counters.

Tolerances: the detector's raw boxes and scores within 1e-3 of the
reference's largest value, as the benchmark's ``det_gap`` measures them
(the same float32 convolutions in another order, their rounding carried
through the seeded stack: up to 1e-4 here); kept boxes compared as sets
at IoU >= 0.99, at most 5% of them without a partner (an NMS decision
that flips at rounding); masks equal but where the logit is within 1e-4
of the largest of 0.
"""

import importlib
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collab_splats_tpu_torch.features import sam_predictor, yolo
from collab_splats_tpu_torch.features.segmentation import Segmentation
from collab_splats_tpu_torch.utils import profiling

torch.set_num_threads(2)
BENCH = Path(__file__).resolve().parents[1] / "benchmark"
PACKAGE = "benchmark_reference"


def reference(name: str):
    """``benchmark/reference/<name>.py``, loaded by path as a module of a
    package of its own (its modules import each other relatively)."""
    if PACKAGE not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            PACKAGE, BENCH / "reference" / "__init__.py",
            submodule_search_locations=[str(BENCH / "reference")])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[PACKAGE] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{PACKAGE}.{name}")


Y, RB, RS = reference("yolo"), reference("boxseg"), reference("sam")
Products = reference("precision").Products
# YOLOv8n as ultralytics builds it (yolov8.yaml scale n).
NANO = Y.Spec((16, 32, 64, 128, 256), (1, 2, 2, 1), (1, 1, 1, 1), 64, 64)
DET = {"imgsz": 640, "pad_multiple": 32, "pad_value": 0.447, "conf": 0.25,
       "iou": 0.5, "max_det": 300}
TINY_SAM = sam_predictor.EncoderSpec(32, 2, 2, (1,))


def frame(seed: int, h: int = 96, w: int = 160) -> np.ndarray:
    """A uint8 frame of smooth colour blobs."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand(3, 3, 5, generator=g)[None]
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear",
                                          align_corners=False)[0]
    return (img.permute(1, 2, 0) * 255).round().to(torch.uint8).numpy()


def yolo_weights(seed: int, imgs):
    """YOLOv8n's seeded weights folded over ``imgs``, the class bias set
    so that about one anchor in twenty passes ``conf`` on them."""
    boxed = torch.stack([Y.letterbox(torch.as_tensor(i).float(), 640, 32,
                                     0.447)[0] for i in imgs])
    p = Y.init_params(NANO, torch.Generator().manual_seed(seed), "cpu",
                      boxed)
    with torch.no_grad():
        logits = torch.cat([Y.forward(p, NANO, b, Products())[1]
                            for b in boxed])
    shift = math.log(1 / 3) - float(torch.quantile(logits[:, 0], 0.95))
    for lvl in range(3):
        p[f"22.cv3.{lvl}.2.b"] += shift + 1e-3
    return p


def sam_weights(seed: int):
    sys.path.insert(0, str(BENCH))
    try:
        from benchlib import box_weights
    finally:
        sys.path.remove(str(BENCH))
    p = RS.init_params(RS.Spec(*TINY_SAM), torch.Generator().manual_seed(
        seed), "cpu")
    box_weights.localise_boxes(p, torch.Generator().manual_seed(seed + 1))
    return p


def _save(path: Path, params) -> str:
    np.savez(path, **{k: v.numpy() for k, v in params.items()})
    return str(path)


@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    _save(tmp_path / "yolov8_objaware.npz",
          yolo_weights(3, [frame(1), frame(2)]))
    _save(tmp_path / "sam_vit_tiny.npz", sam_weights(5))
    monkeypatch.setenv("COLLAB_SPLATS_WEIGHTS", str(tmp_path))
    monkeypatch.setitem(sam_predictor.SAM_ENCODERS, "vit_tiny", TINY_SAM)
    return tmp_path


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lo = torch.maximum(a[:, None, :2], b[None, :, :2])
    hi = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(dim=2)
    area = (a[:, 2:] - a[:, :2]).prod(1)[:, None] + \
        (b[:, 2:] - b[:, :2]).prod(1)[None]
    return inter / (area - inter)


@pytest.mark.parametrize("seed", [1, 2])
def test_object_path_matches_the_references(weights_dir, seed):
    img = frame(seed)
    seg = Segmentation(device="cpu", sam_model="vit_tiny", yolo_model="n")
    assert seg.detector.model == "n"
    got = seg.auto_segment_image(img)
    yp = {k: torch.from_numpy(v) for k, v in
          np.load(weights_dir / "yolov8_objaware.npz").items()}
    sp = {k: torch.from_numpy(v) for k, v in
          np.load(weights_dir / "sam_vit_tiny.npz").items()}
    x = torch.as_tensor(img).float()
    ref = Y.detect(yp, NANO, x, DET, Products())
    # The raw head outputs.
    padded, _ = seg.detector.letterbox(img)
    boxes, scores = yolo.yolo_forward(seg.detector.params, padded)
    for a, b in ((boxes, ref.boxes), (scores.amax(1), ref.scores)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3
    # The kept boxes, as sets: an NMS decision at rounding's distance
    # from its threshold may flip and move a few.  (Scores that round to
    # 1 would tie, and the two NMS break ties apart.)
    assert float(ref.scores.max()) < 1.0
    kept, confs = seg.detector(img)
    same = _iou(torch.from_numpy(kept), ref.kept) >= 0.99
    lone = int((~same.any(1)).sum()) + int((~same.any(0)).sum())
    assert len(kept) >= 5 and lone <= 0.05 * (len(kept) + len(ref.kept))
    # The masks of the program's boxes.
    r = RB.segment_boxes(sp, x, torch.from_numpy(kept), RS.Precision())
    assert len(got) == len(r.kept) > 0
    low = RB.low_logits(sp, r.embedding, torch.from_numpy(kept),
                        1024 / 160, RS.Precision())[0]
    for g, k in zip(got, r.kept):
        near = RS.upscale(low[k["box"]][None], (96, 160), (614, 1024))[0]
        near = near.abs() <= 1e-4 * float(low.abs().max())
        diff = torch.from_numpy(g["segmentation"]) != k["segmentation"]
        assert not bool((diff & ~near).any())
        assert abs(g["area"] - k["area"]) <= int(near.sum())
        assert g["predicted_iou"] == pytest.approx(k["predicted_iou"],
                                                   abs=1e-5)
    assert [g["stability_score"] for g in got] == pytest.approx(
        confs[[k["box"] for k in r.kept]].tolist())


def host_loop(sam, image, boxes_xyxy, confs=None, batch_size=64):
    """``SamBackend.segment_boxes`` as it was: each batch's masks to the
    host, the area and box of each by numpy."""
    sam.set_image(image)
    results = []
    h, w = image.shape[:2]
    confs = np.ones(len(boxes_xyxy)) if confs is None else confs
    for s0 in range(0, len(boxes_xyxy), batch_size):
        masks, ious = sam.predict_boxes(boxes_xyxy[s0:s0 + batch_size])
        for mask, iou, conf in zip(masks, ious,
                                   confs[s0:s0 + batch_size]):
            area = int(mask.sum())
            if area == 0:
                continue
            ys, xs = np.where(mask)
            results.append({
                "segmentation": mask, "area": area,
                "bbox": [int(xs.min()), int(ys.min()),
                         int(xs.max() - xs.min()), int(ys.max() - ys.min())],
                "predicted_iou": float(iou), "point_coords": [],
                "stability_score": float(conf), "crop_box": [0, 0, w, h]})
    return results


@pytest.mark.parametrize("batch, with_confs", [(64, True), (3, False)])
def test_segment_boxes_matches_the_host_loop(weights_dir, batch,
                                             with_confs):
    """Boxes inside the frame give masks, boxes far outside it give
    empty ones, which both drop; everything else is equal, in order."""
    sam = sam_predictor.SamBackend(device="cpu", model="vit_tiny")
    img = frame(4)
    g = torch.Generator().manual_seed(6)
    xy = torch.rand(9, 2, generator=g) * torch.tensor([150.0, 80.0])
    boxes = torch.cat([xy, xy + 10 + 30 * torch.rand(9, 2, generator=g)], 1)
    boxes[[1, 4, 5]] = torch.tensor([-600.0, -600.0, -500.0, -500.0])
    boxes = boxes.numpy()
    confs = np.linspace(0.3, 0.9, 9).astype(np.float32) if with_confs \
        else None
    want = host_loop(sam, img, boxes, confs, batch)
    got = sam.segment_boxes(img, boxes, confs, batch)
    assert 3 <= len(got) == len(want) <= 6
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a.pop("segmentation"),
                                      b.pop("segmentation"))
        assert a == b
        assert type(a["predicted_iou"]) is float
    assert sam.segment_boxes(img, boxes[:0]) == []


@pytest.mark.parametrize("model, ok", [(None, True), ("n", True),
                                       ("s", False), ("x", False),
                                       ("h", False)])
def test_yolo_scales_refuse_other_widths(tmp_path, model, ok):
    path = _save(tmp_path / "y.npz", yolo_weights(0, [frame(1)]))
    if ok:
        assert yolo.ObjectAwareDetector(path, device="cpu",
                                        model=model).model == model
    else:
        with pytest.raises(ValueError):
            yolo.ObjectAwareDetector(path, device="cpu", model=model)


def test_scale_tables_are_ultralytics():
    """The program's table at scale x is the benchmark's configuration,
    and at n the reference's nano layers; YOLOv8x holds 68.1M weights."""
    x = Y.Spec((80, 160, 320, 640, 640), (3, 6, 6, 3), (3, 3, 3, 3), 80,
               320)
    assert yolo.scale_shapes("x") == Y.shapes(x)
    assert yolo.scale_shapes("n") == Y.shapes(NANO)
    assert sum(math.prod(s) for s in yolo.scale_shapes("x").values()) == \
        68_124_515


@pytest.mark.parametrize("found", [True, False])
def test_object_path_spans_and_counters(weights_dir, found, monkeypatch):
    seg = Segmentation(device="cpu", sam_model="vit_tiny", yolo_model="n")
    if not found:
        monkeypatch.setattr(seg.detector, "conf", 1.1)
    img = frame(2)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = seg.auto_segment_image(img)
    t = profiling.totals()
    spans, c = t["spans"], t["counters"]
    # One frame, one sam.image, also when the grid takes over.
    assert spans["sam.image"]["count"] == 1
    for name in ("yolo.detect", "yolo.nms", "sync.yolo", "sam.encode"):
        assert spans[name]["count"] == 1
        assert spans[name]["parents"] in (["sam.image"], ["yolo.nms"])
    assert c["yolo.anchors"] == 80 * 48 * (1 + 1 / 4 + 1 / 16)
    if found:
        assert c["yolo.passed"] >= c["yolo.kept"] == c["sam.prompts"] >= 5
        assert c["sam.kept"] == len(out) > 0
        assert spans["sam.decode"]["count"] == math.ceil(c["sam.prompts"]
                                                         / 64)
        assert spans["sam.boxes"]["count"] == spans["sync.sam"]["count"] == 1
        assert c["host_syncs"] == 2
    else:
        assert c["yolo.passed"] == c["yolo.kept"] == 0
        assert "sam.boxes" not in spans and "sam.filter" in spans

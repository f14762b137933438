"""The box-segmentation cell: YOLOv8's operation count, the references'
agreement with ultralytics' arithmetic where it can be shown by hand, the
loop end to end on the CPU at a tiny size with its check, faults and
traced metrics, and its discovery by name."""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchlib import box_weights, scene, spec
from conftest import BENCH, ROOT, run_cell, tiny_copy
from counts import yolo as yolo_counts

BOXSEG = "segment-yolov8x-sam-vit-h-boxes-720p"
CONFIG = json.loads((BENCH / "configs" /
                     "mobilesamv2-yolov8x-sam-vit-h.json").read_text())
METRICS = {"detect_card_ms.boxseg", "nms_card_ms.boxseg",
           "encode_card_ms.boxseg", "decode_card_ms.boxseg",
           "results_card_ms.boxseg", "boxes_per_image.boxseg",
           "host_syncs.boxseg", "idle_pct.boxseg", "mfu.boxseg"}
LIMITS = {"embed_gap": 1e-4, "det_gap": 1e-4, "box_mismatch": 0.0,
          "logit_gap": 1e-4, "mask_mismatch": 0.0}
# A detector scale of the test's own: YOLOv8's layers at an eighth of
# the widths, one repeat.
TINY_SCALE = (0.33, 0.125, 1024)
TINY_DETECTOR = {"scale": "tiny", "depth_multiple": 0.33,
                 "width_multiple": 0.125, "max_channels": 1024,
                 "widths": [8, 16, 32, 64, 128],
                 "backbone_repeats": [1, 2, 2, 1],
                 "neck_repeats": [1, 1, 1, 1], "box_branch": 64,
                 "class_branch": 32}


def test_the_cell_its_mix_and_metrics_are_found_by_name():
    c = spec.find(ROOT, BENCH, BOXSEG)
    assert c.traffic["loop"] == "boxseg" and c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "step_ms"}
    assert {m["name"] for m in c.per_layer} == METRICS
    assert set(spec.readers(c)) == METRICS
    assert spec.loop(c).run


def test_yolov8x_counts_ultralytics_gflops():
    det = CONFIG["detector"]
    # ultralytics reports 257.8 GFLOPs for the 80-class YOLOv8x at
    # 640x640; one class takes 320 x 79 x 2 x 8400 of them away.
    at640 = yolo_counts.detect(det, 640, 640)
    assert at640 == pytest.approx(257.8e9 - 2 * 320 * 79 * 8400, rel=2e-3)
    assert yolo_counts.detect(det, 720, 1280) == pytest.approx(0.6 * at640,
                                                               rel=1e-9)


def test_the_configuration_matches_the_program():
    from collab_splats_tpu_torch.features import sam_predictor, yolo
    from loops import boxseg

    boxseg.check_program(CONFIG, sam_predictor, yolo)
    bad = json.loads(json.dumps(CONFIG))
    bad["detector"]["widths"][2] = 256
    with pytest.raises(ValueError):
        boxseg.check_program(bad, sam_predictor, yolo)


@pytest.mark.parametrize("seed", [3, 2147483655])
def test_box_masks_localise_at_the_corners(seed):
    """The decoder that box_weights builds gives every box a mask, blobs
    around its corners that stay a few percent of the frame."""
    from collab_splats_tpu_torch.features import sam as S
    from reference import sam as R

    p = R.init_params(R.Spec(32, 1, 2, (0,)),
                      torch.Generator().manual_seed(seed), "cpu")
    box_weights.localise_boxes(p, torch.Generator().manual_seed(seed + 1))
    frame = scene.smooth_images(seed, 1, 720, 1280, "cpu")[0] * 255.0
    emb = R.encode(p, R.preprocess(frame), R.Precision())
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(40, 2, generator=g) * torch.tensor([1200.0, 680.0])
    wh = torch.rand(40, 2, generator=g) * 300 + 20
    boxes = torch.cat([xy, torch.minimum(xy + wh, torch.tensor(
        [1279.0, 719.0]))], 1) * 0.8
    low, _ = S.mask_decoder_forward(p, emb, S.dense_pe(p),
                                    S.encode_boxes(p, boxes),
                                    multimask=False,
                                    ln_eps=S.DECODER_LN_EPS)
    area = (low[:, 0, :144] > 0).sum(dim=(1, 2)).double()
    assert bool((area > 0).all())
    assert float(area.max()) < 0.08 * 256 * 144
    for b, lg in zip((boxes / 4).tolist(), low[:, 0]):
        assert lg[int(b[1]), int(b[0])] > 0 or lg[int(b[3]), int(b[2])] > 0


# ------------------------------------------------------ the loop on CPU
TINY_TRAFFIC = {"frames": 4, "width": 64, "height": 48, "check_images": 2,
                "trace_images": 1, "fold_images": 2, "target_kept": 20,
                "floor_kept": 5}


def _update(path: Path, fn):
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


@pytest.fixture
def tiny_boxseg_root(tmp_path, monkeypatch):
    """A tiny checkout: SAM 32 wide (2 blocks, the second global) and
    YOLOv8 at an eighth of its widths under names the program is given
    for the test, 64x48 frames."""
    from collab_splats_tpu_torch.features import sam_predictor, yolo

    root = tiny_copy(tmp_path)
    bench = root / BENCH.name
    monkeypatch.setitem(sam_predictor.SAM_ENCODERS, "vit_tiny",
                        sam_predictor.EncoderSpec(32, 2, 2, (1,)))
    monkeypatch.setitem(yolo.YOLO_SCALES, "tiny", TINY_SCALE)

    def cfg(c):
        c["model"] = "vit_tiny"
        c["detector_model"] = "tiny"
        c["image_encoder"].update(embed_dim=32, depth=2, num_heads=2,
                                  global_attn_indexes=[1])
        c["detector"].update(TINY_DETECTOR)

    _update(bench / "configs" / "mobilesamv2-yolov8x-sam-vit-h.json", cfg)
    _update(bench / "traffic" / "segment-boxes-720p.json",
            lambda t: t.update(TINY_TRAFFIC))
    (bench / "limits" / f"{BOXSEG}.json").write_text(json.dumps(
        {k: {"limit": v} for k, v in LIMITS.items()}))
    return root


def test_the_tiny_scale_is_the_tiny_detector():
    from collab_splats_tpu_torch.features import yolo
    from reference import yolo as Y

    d = dict(CONFIG["detector"], **TINY_DETECTOR)
    yolo.YOLO_SCALES["tiny"] = TINY_SCALE
    try:
        assert yolo.scale_shapes("tiny") == Y.shapes(Y.spec(d))
    finally:
        del yolo.YOLO_SCALES["tiny"]


def test_the_boxseg_loop_runs_and_checks_on_the_cpu(tiny_boxseg_root,
                                                    capsys):
    code, line = run_cell(tiny_boxseg_root, BOXSEG, seed=2147483651,
                          capsys=capsys)
    assert code == 0 and line is not None
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "step_ms"}
    assert set(line["compared"]) == set(LIMITS)
    cache = tiny_boxseg_root / "build" / "bench_cache"
    assert not cache.exists() or not list(cache.glob("boxseg-*"))


def test_the_boxseg_loop_traces_its_metrics(tiny_boxseg_root, capsys,
                                            monkeypatch):
    import run as harness
    from benchlib import trace

    real = trace.from_profiler

    def with_device(prof):
        ev = real(prof)
        w = next(e for e in ev if e.name == trace.WINDOW_SPAN)
        return ev + [trace.Event("kernel", True, w.start_us, w.end_us)]

    monkeypatch.setattr(trace, "from_profiler", with_device)
    code = harness.main(["--workload", BOXSEG, "--seed", "7", "--seconds",
                         "0.2", "--trace", "1"], root=tiny_boxseg_root,
                        device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and line["correct"]
    m = line["metrics"]
    # Card times need a card: none on the CPU.
    assert set(m) == {"boxes_per_image.boxseg", "host_syncs.boxseg",
                      "idle_pct.boxseg", "mfu.boxseg"}
    # The detector's read and the masks' read.
    assert m["host_syncs.boxseg"]["value"] == 2.0
    assert m["boxes_per_image.boxseg"]["value"] >= 1
    assert m["mfu.boxseg"]["value"] > 0


def test_faults_are_caught(tiny_boxseg_root):
    """The check tells the program from references with the anchors off
    the cells' centres and with the box corners' embeddings swapped."""
    import run as harness
    from loops import boxseg

    cell = spec.find(tiny_boxseg_root, tiny_boxseg_root / BENCH.name,
                     BOXSEG)
    ctx = harness.Context(argparse.Namespace(seed=5, seconds=0.0, trace=0),
                          cell, "cpu", time.perf_counter())
    seg, fs, checked = boxseg.setup(ctx)
    del seg
    k = ctx.traffic["check_images"]
    good = boxseg.compare(checked, boxseg.reference_images(ctx, fs[:k],
                                                           checked))
    assert all(v <= LIMITS[n] for n, v in good.items()), good
    off = boxseg.compare(checked, boxseg.reference_images(
        ctx, fs[:k], checked, centre=0.0))
    assert off["det_gap"] > 100 * max(good["det_gap"], 1e-7)
    swapped = boxseg.compare(checked, boxseg.reference_images(
        ctx, fs[:k], checked, corners=(3, 2)))
    assert swapped["logit_gap"] > 100 * max(good["logit_gap"], 1e-7)


def test_kept_counts_by_hand():
    from loops import boxseg

    boxes = np.array([[0, 0, 10, 10], [1, 0, 11, 10], [20, 20, 30, 30],
                      [0, 0, 10, 10.5]], np.float64)
    scores = np.array([0.9, 0.8, 0.7, 0.95])
    # 4 suppresses 1 and 2 (IoU over 0.5); 3 stays.
    assert boxseg._kept_count(boxes, scores, 0.5, 300) == 2
    assert boxseg._kept_count(boxes, scores, 0.5, 1) == 1
    assert boxseg._kept_count(boxes, scores, 0.99, 300) == 4
    a = torch.tensor([[0.0, 0, 10, 10], [50, 50, 60, 60]])
    b = torch.tensor([[0.0, 0, 10, 10.5]])
    assert boxseg.box_mismatch(a, b) == pytest.approx(1 / 3)

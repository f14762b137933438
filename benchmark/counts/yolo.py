"""Frozen float32 operation counts of MobileSAMv2's object-aware
segmentation of one frame, from the configuration's widths alone: YOLOv8's
convolutions at the letterboxed frame's size, SAM's encoder and its
decoder once a box.  A product counts 2 operations per multiply-add; the
activations, pools, the DFL softmax and the NMS are left out."""

from __future__ import annotations

from counts import sam


def detect(det: dict, height: int, width: int) -> int:
    """YOLOv8's convolutions on one ``height`` x ``width`` frame
    letterboxed to ``imgsz``, padded to multiples of ``pad_multiple``."""
    scale = det["imgsz"] / max(height, width)
    pad = det["pad_multiple"]
    h = -(-int(round(height * scale)) // pad) * pad
    w = -(-int(round(width * scale)) // pad) * pad
    c0, c1, c2, c3, c4 = det["widths"]
    b, n = det["backbone_repeats"], det["neck_repeats"]
    ops = 0

    def conv(cin, cout, k, stride_out):
        nonlocal ops
        ops += 2 * (h // stride_out) * (w // stride_out) * k * k * cin * cout

    def c2f(cin, cout, reps, s):
        c = cout // 2
        conv(cin, 2 * c, 1, s)
        for _ in range(reps):
            conv(c, c, 3, s)
            conv(c, c, 3, s)
        conv((2 + reps) * c, cout, 1, s)

    conv(3, c0, 3, 2)
    conv(c0, c1, 3, 4)
    c2f(c1, c1, b[0], 4)
    conv(c1, c2, 3, 8)
    c2f(c2, c2, b[1], 8)
    conv(c2, c3, 3, 16)
    c2f(c3, c3, b[2], 16)
    conv(c3, c4, 3, 32)
    c2f(c4, c4, b[3], 32)
    conv(c4, c4 // 2, 1, 32)
    conv(c4 // 2 * 4, c4, 1, 32)
    c2f(c4 + c3, c3, n[0], 16)
    c2f(c3 + c2, c2, n[1], 8)
    conv(c2, c2, 3, 16)
    c2f(c2 + c3, c3, n[2], 16)
    conv(c3, c3, 3, 32)
    c2f(c3 + c4, c4, n[3], 32)
    for cin, s in zip((c2, c3, c4), det["strides"]):
        for mid, last in ((det["box_branch"], 4 * det["reg_max"]),
                          (det["class_branch"], det["nc"])):
            conv(cin, mid, 3, s)
            conv(mid, mid, 3, s)
            conv(mid, last, 1, s)
    return ops


def frame(cfg: dict, height: int, width: int, boxes: int) -> int:
    """One frame's operations under ``configs/mobilesamv2-*.json``: the
    detector, SAM's encoder, and the decoder for each of ``boxes`` boxes
    (the iou token, four mask tokens and two corners: seven tokens)."""
    e, d = cfg["image_encoder"], cfg["mask_decoder"]
    grid = e["img_size"] // e["patch_size"]
    enc = sam.encoder(e["embed_dim"], e["depth"], e["num_heads"],
                      e["global_attn_indexes"], e["window_size"], grid,
                      e["patch_size"], e["mlp_ratio"], e["out_chans"])
    dec = sam.decoder_per_prompt(
        d["transformer_dim"], d["depth"], d["mlp_dim"],
        d["attention_downsample_rate"], tokens=1 + d["num_multimask_outputs"]
        + 1 + 2, mask_tokens=d["num_multimask_outputs"] + 1, grid=grid,
        upscale=(d["transformer_dim"] // 4, d["transformer_dim"] // 8))
    return detect(cfg["detector"], height, width) + enc + boxes * dec

"""SAM's mask upscaling (``features/sam.py::upscale_masks``): the plain
chain on the CPU, the fused kernel (``ops/cuda/sam_upscale.py``) on the card.

On the CPU:

* ``upscale_masks_plain`` is the decoder's former inline chain, bit for bit;
* the products-and-pixel-shuffle form in the kernel's index order (W1' as
  [256, (dy, dx, 64)], W2' as [64, (dy2, dx2, 32)], output pixel (4y + 2dy
  + dy2, 4x + 2dx + dx2)) computes the same masks to rounding: it is what
  the kernel computes;
* the wrapper refuses what the kernel does not take, and reshapes a
  model's weights once, again after they change;
* ``sam.upscale`` is recorded once per decode and ``sam.fused_up`` reads 0.

On a card (marked ``card``; ``python -m pytest --noconftest -p
no:cacheprovider -m card tests/test_torch_sam_upscale_op.py``): the kernel
against ``upscale_masks_plain`` at B = 1, 7 and 64, on seeded weights and on
the segment cell's localised ones, and the decoder with the kernel against
the plain reference within ``test_torch_sam_vit_h.py``'s limits.
"""

import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import plain_sam as R
from collab_splats_tpu_torch.features import sam as S
from collab_splats_tpu_torch.ops.cuda import build
from collab_splats_tpu_torch.ops.cuda import sam_upscale as op
from collab_splats_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
UP_KEYS = ("dec.up1.w", "dec.up1.b", "dec.up_ln.scale", "dec.up_ln.bias",
           "dec.up2.w", "dec.up2.b")


def seeded(seed, device="cpu"):
    """The upscaling's weights at SAM's widths, every term nonzero."""
    g = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=g)).to(device)

    return {"dec.up1.w": draw(2, 2, 64, 256, scale=256 ** -0.5),
            "dec.up1.b": draw(64, scale=0.1),
            "dec.up_ln.scale": draw(64, scale=0.2, shift=1.0),
            "dec.up_ln.bias": draw(64, scale=0.1),
            "dec.up2.w": draw(2, 2, 32, 64, scale=64 ** -0.5),
            "dec.up2.b": draw(32, scale=0.1)}


def localised(seed, device="cpu"):
    """The segment cell's constructed decoder
    (``benchmark/benchlib/sam_weights.py::localise``): its upscaling's
    weights, and hypernetwork outputs shaped like its slots' (a steep
    threshold on two channels over seeded small ones)."""
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        from benchlib import sam_weights
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    p = R.init_params(R.Spec(32, 1, 2, (0,)),
                      torch.Generator().manual_seed(seed), "cpu")
    sam_weights.localise(p, torch.Generator().manual_seed(seed + 1))
    return {k: p[k].to(device) for k in UP_KEYS}


def inputs(b, m, seed, device="cpu", steep=False):
    g = torch.Generator().manual_seed(seed)
    im = torch.randn((b, 4096, 256), generator=g)
    hyper = torch.randn((b, m, 32), generator=g)
    if steep:
        hyper = 0.01 * hyper
        hyper[..., 0] = 1000.0
        hyper[..., 1] = -1000.0 * torch.rand((b, m), generator=g)
    return im.to(device), hyper.to(device)


def inline_chain(params, im, hyper):
    """The chain ``mask_decoder_forward`` ran inline before it was
    factored out."""
    b = im.shape[0]
    x = im.transpose(1, 2).reshape(b, S.PROMPT_DIM, S.EMBED_HW, S.EMBED_HW)
    x = F.conv_transpose2d(x, params["dec.up1.w"].permute(3, 2, 0, 1),
                           params["dec.up1.b"], stride=2)
    x = S.layer_norm(x.permute(0, 2, 3, 1), params["dec.up_ln.scale"],
                     params["dec.up_ln.bias"]).permute(0, 3, 1, 2)
    x = F.gelu(x)
    x = F.gelu(F.conv_transpose2d(
        x, params["dec.up2.w"].permute(3, 2, 0, 1), params["dec.up2.b"],
        stride=2))
    return (hyper @ x.flatten(2)).reshape(b, hyper.shape[1], *x.shape[2:])


def product_form(params, im, hyper):
    """Two products and a pixel shuffle, in the kernel's index order."""
    b, m = im.shape[0], hyper.shape[1]
    w1 = params["dec.up1.w"].permute(3, 0, 1, 2).reshape(256, 256)
    y1 = (im @ w1 + params["dec.up1.b"].repeat(4)).reshape(b, 4096, 4, 64)
    y1 = F.gelu(F.layer_norm(y1, (64,), params["dec.up_ln.scale"],
                             params["dec.up_ln.bias"], 1e-6))
    w2 = params["dec.up2.w"].permute(3, 0, 1, 2).reshape(64, 128)
    y2 = F.gelu(y1 @ w2 + params["dec.up2.b"].repeat(4))
    out = y2.reshape(b, 4096, 4, 4, 32) @ hyper.transpose(1, 2)[:, None,
                                                                 None]
    # (b, y, x, dy, dx, dy2, dx2, m) -> (b, m, 4y + 2dy + dy2, 4x + 2dx + dx2)
    out = out.reshape(b, 64, 64, 2, 2, 2, 2, m)
    return out.permute(0, 7, 1, 3, 5, 2, 4, 6).reshape(b, m, 256, 256)


def gap(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("m", [1, 4])
def test_plain_is_the_former_inline_chain(b, m):
    p = seeded(b + 10 * m)
    im, hyper = inputs(b, m, seed=b + m)
    assert torch.equal(S.upscale_masks_plain(p, im, hyper),
                       inline_chain(p, im, hyper))


@pytest.mark.parametrize("weights", ["seeded", "localised"])
def test_the_kernels_product_form_matches_the_plain_chain(weights):
    # Readings 2.6e-7 (seeded) and 4.9e-7 (localised) of the largest
    # logit: the same float32 sums in another order.
    if weights == "seeded":
        p, (im, hyper) = seeded(3), inputs(2, 4, seed=4)
    else:
        p, (im, hyper) = localised(3), inputs(2, 4, seed=4, steep=True)
    ref = S.upscale_masks_plain(p, im, hyper)
    assert gap(product_form(p, im, hyper), ref) <= 1e-6


def _bad(case):
    """(params, im, hyper) wrong in one way only, all on the CPU but for
    ``device``."""
    p = seeded(1)
    im, hyper = inputs(2, 4, seed=2)
    if case == "im width":
        im = im[..., :128].contiguous()
    elif case == "hyper width":
        hyper = hyper[..., :16].contiguous()
    elif case == "slots":
        hyper = torch.cat([hyper, hyper[:, :1]], dim=1)
    elif case == "weight width":
        p["dec.up2.w"] = p["dec.up2.w"][:, :, :16].contiguous()
    elif case == "dtype":
        im = im.double()
    elif case == "weight dtype":
        p["dec.up1.b"] = p["dec.up1.b"].double()
    elif case == "non-contiguous":
        im = im.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "requires grad":
        im.requires_grad_(True)
    elif case == "weight requires grad":
        p["dec.up_ln.scale"].requires_grad_(True)
    return p, im, hyper


@pytest.mark.parametrize("case", [
    ("im width", "must be"), ("hyper width", "must be"),
    ("slots", "must be"), ("weight width", "dec.up2.w must be"),
    ("dtype", "float32"), ("weight dtype", "dec.up1.b must be float32"),
    ("non-contiguous", "contiguous"), ("requires grad", "forward only"),
    ("weight requires grad", "forward only"), ("device", "CUDA device")],
    ids=lambda c: c[0])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    what, message = case
    launches = build.launches["sam_upscale"]
    with pytest.raises(ValueError, match=message):
        op.upscale_masks(*_bad(what))
    assert build.launches["sam_upscale"] == launches


def test_the_reshaped_weights_follow_the_parameters():
    def expect(p):
        return [p["dec.up1.w"].permute(3, 0, 1, 2).reshape(256, 256),
                *(p[k] for k in UP_KEYS[1:4]),
                p["dec.up2.w"].permute(3, 0, 1, 2).reshape(64, 128),
                p["dec.up2.b"]]

    p = seeded(7)
    first = op._weights(p)
    assert all(torch.equal(a, b) for a, b in zip(first, expect(p)))
    again = op._weights(p)
    assert again[0] is first[0] and again[4] is first[4]
    p["dec.up1.w"].mul_(2.0)
    p["dec.up2.w"][0, 1, 3, 5] = 9.0
    changed = op._weights(p)
    assert all(torch.equal(a, b) for a, b in zip(changed, expect(p)))
    q = seeded(8)
    assert all(torch.equal(a, b) for a, b in zip(op._weights(q), expect(q)))


def test_upscale_span_and_counter_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

    p = R.init_params(R.Spec(32, 1, 2, (0,)),
                      torch.Generator().manual_seed(0), "cpu")
    emb = torch.randn((256, 64, 64), generator=torch.Generator(
    ).manual_seed(1))
    pts = torch.tensor([[[10.0, 20.0]], [[500.0, 300.0]]])
    sparse = S.encode_points(p, pts, torch.ones((2, 1), dtype=torch.int32))
    profiling.reset()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("sam.decode"):
                S.mask_decoder_forward(p, emb, S.dense_pe(p), sparse,
                                       multimask=True)
    t = profiling.totals()
    profiling.reset()
    assert t["spans"]["sam.upscale"]["count"] == 3
    assert t["spans"]["sam.upscale"]["parents"] == ["sam.decode"]
    assert t["counters"]["sam.fused_up"] == 0


# ------------------------------------------------------------------- card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("weights", ["seeded", "localised"])
def test_kernel_matches_the_plain_chain_on_the_card(b, weights):
    dev = _card()
    make = seeded if weights == "seeded" else localised
    p = make(5, dev)
    im, hyper = inputs(b, 4, seed=b, device=dev,
                       steep=weights == "localised")
    launches = build.launches["sam_upscale"]
    with torch.no_grad():
        got = S.upscale_masks(p, im, hyper)
        again = op.upscale_masks(p, im, hyper)
        ref = S.upscale_masks_plain(p, im, hyper)
    torch.cuda.synchronize()
    assert build.launches["sam_upscale"] == launches + 2
    assert torch.equal(got, again)
    assert gap(got, ref) <= 1e-5


@pytest.mark.card
@pytest.mark.parametrize("multimask", [True, False], ids=["multi", "single"])
def test_the_decoder_holds_the_reference_limits_on_the_card(multimask):
    import test_torch_sam_vit_h as V

    dev = _card()
    p = V.params()
    img = torch.randn((R.IMG, R.IMG, 3), generator=torch.Generator(
    ).manual_seed(1))
    emb = R.encode(p, img, R.Precision())
    pts = torch.tensor([[10.0, 20.0], [500.0, 300.0], [1000.5, 3.0],
                        [640.0, 700.0]])
    pc = {k: v.to(dev) for k, v in p.items()}
    launches = build.launches["sam_upscale"]
    with torch.no_grad():
        sparse = S.encode_points(pc, pts[:, None].to(dev),
                                 torch.ones((4, 1), dtype=torch.int32,
                                            device=dev))
        low, iou = S.mask_decoder_forward(pc, emb.to(dev), S.dense_pe(pc),
                                          sparse, multimask=multimask,
                                          ln_eps=S.DECODER_LN_EPS)
    assert build.launches["sam_upscale"] == launches + 1
    pe = R.dense_pe(p)
    ref = [R.decode(p, emb, pe, R.point_tokens(p, xy), R.Precision(),
                    multimask) for xy in pts]
    assert gap(low.cpu(), torch.stack([r[0] for r in ref])) <= V.LOGIT_TOL
    assert float((iou.cpu() - torch.stack([r[1] for r in ref])).abs().max()
                 ) <= V.IOU_TOL

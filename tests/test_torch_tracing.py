"""The port's spans and counters (``utils/profiling.py``): they record
exactly while a ``torch.profiler`` session records, nest as the training
step and the render path lay them out, count once per step, and cost the
step nothing when off."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from collab_splats_tpu_torch.core.options import RenderOptions
from collab_splats_tpu_torch.data.synthetic import (orbit_cameras,
                                                    random_gaussian_params)
from collab_splats_tpu_torch.models import rade_gs
from collab_splats_tpu_torch.models.gaussians import (activated_opacity,
                                                      activated_scales,
                                                      pad_to_capacity)
from collab_splats_tpu_torch.ops import rasterize
from collab_splats_tpu_torch.train import strategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig
from collab_splats_tpu_torch.utils import profiling
from collab_splats_tpu_torch.utils.stages import StageTimer

torch.set_num_threads(2)
CAP = 512
N = 200
NO_REFINE = 10_000_000

# Each span of a training step and the span it sits in.
STEP_SPANS = {
    "train.step": None,
    "train.inputs": "train.step",
    "train.render": "train.step",
    "render.colors": "train.render",
    "render.project": "train.render",
    "render.bin": "train.render",
    "render.composite": "train.render",
    "train.loss": "train.step",
    "train.backward": "train.step",
    "train.update": "train.step",
    "train.guard": "train.update",
    "sync.finite": "train.guard",
    "train.adam": "train.update",
    "train.strategy": "train.update",
    "train.metrics": "train.step",
    "sync.metrics": "train.metrics",
}
# ... and on a refine step besides.
REFINE_SPANS = {"train.refine": "train.step", "sync.alive": "train.refine"}


@pytest.fixture(scope="module")
def scene():
    gt = random_gaussian_params(torch.Generator().manual_seed(0), N,
                                extent=0.6, scale_range=(0.02, 0.08),
                                device="cpu")
    cams = orbit_cameras(4, radius=2.5, width=32, height=32, focal=35.2,
                         device="cpu")
    cfg = model_config("xla")
    alive = torch.ones(N, dtype=torch.bool)
    with torch.no_grad():
        images = [rade_gs.get_outputs(gt, alive, c, 0, cfg,
                                      training=False)[0]["rgb"]
                  for c in cams]
    init = dict(gt)
    init["means"] = gt["means"] + 0.02 * torch.randn(
        gt["means"].shape, generator=torch.Generator().manual_seed(7))
    init["features_dc"] = torch.zeros_like(gt["features_dc"])
    return pad_to_capacity(init, CAP), torch.arange(CAP) < N, cams, images


def model_config(backend: str, tile_capacity: int = 256,
                 max_intersections: int = 1 << 15):
    return rade_gs.RadeGSConfig(
        sh_degree=0, background="black", use_depth_normal_loss=False,
        render=RenderOptions(tile_capacity=tile_capacity,
                             max_intersections=max_intersections,
                             backend=backend))


def trainer(scene, backend="xla", refine_every=None):
    """A trainer on the tiny scene; with ``refine_every`` its refines are
    cull-only from the first step on."""
    init, alive, cams, images = scene
    scfg = strategy.StrategyConfig(warmup_length=NO_REFINE) \
        if refine_every is None else strategy.StrategyConfig(
            warmup_length=0, refine_every=refine_every, stop_split_at=0)
    conf = TrainerConfig(model=model_config(backend), strategy=scfg,
                         max_iterations=200)
    return Trainer(conf, cams, images, init, alive, device="cpu")


def recorded_steps(tr, n: int):
    """``n`` steps of ``tr`` under a CPU profiler session: (the
    profiler's events, the totals)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            tr.train_one_step()
    return prof.events(), profiling.totals()


def test_off_records_nothing_and_enters_no_record_function(scene,
                                                           monkeypatch):
    """Off, a span enters no ``record_function`` (torch's own, such as
    Adam's, still do) and a counter's callable is never called."""
    entered = []
    real = torch.autograd.profiler.record_function

    def watch(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    def refuse():
        raise AssertionError("a counter evaluated with recording off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", watch)
    profiling.reset()
    assert not profiling.enabled()
    with profiling.span("x", step=1):
        profiling.count("c", 1)
        profiling.count("d", refuse)
    trainer(scene).train_one_step()
    assert not set(entered) & (set(STEP_SPANS) | {"x"})
    assert profiling.totals() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("second", ["off", "on"])
def test_recording_leaves_the_steps_bit_identical(scene, second):
    """Two trainers from one seed, the second with recording off or on:
    the same losses and parameters, bit for bit, after 3 steps."""
    a, b = trainer(scene), trainer(scene)
    la = [a.train_one_step()["loss"] for _ in range(3)]
    if second == "on":
        with profile(activities=[ProfilerActivity.CPU]):
            lb = [b.train_one_step()["loss"] for _ in range(3)]
    else:
        lb = [b.train_one_step()["loss"] for _ in range(3)]
    assert la == lb
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def _inside(child, parent) -> bool:
    return (parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_every_span_is_a_profiler_event_nested_as_listed(scene, backend):
    events, totals = recorded_steps(trainer(scene, backend), 2)
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    for name, parent in STEP_SPANS.items():
        assert len(by_name.get(name, [])) == 2, name
        assert totals["spans"][name]["parents"] == [parent], name
        if parent is not None:
            for e in by_name[name]:
                assert any(_inside(e, p) for p in by_name[parent]), name


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_totals_count_each_span_once_a_step(scene, backend):
    _, totals = recorded_steps(trainer(scene, backend), 3)
    spans = totals["spans"]
    assert set(spans) == set(STEP_SPANS)
    for name, s in spans.items():
        assert s["count"] == 3, name
        assert 0.0 <= s["self_host_s"] <= s["host_s"], name
        assert s["card_s"] is None, name   # no card on the CPU
    step = spans["train.step"]
    children = sum(spans[k]["host_s"] for k, p in STEP_SPANS.items()
                   if p == "train.step")
    assert step["self_host_s"] == pytest.approx(step["host_s"] - children,
                                                rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("refine, syncs", [(False, 2), (True, 3)])
def test_host_syncs_per_step(scene, refine, syncs):
    """Two reads a step (the finite guard, the metrics); a cull refine
    step adds the capacity check's alive count."""
    tr = trainer(scene, refine_every=5 if refine else None)
    if refine:
        tr.step = 4   # the step taken is 4, the refine at 5
    _, totals = recorded_steps(tr, 1)
    assert totals["counters"]["host_syncs"] == syncs
    has_refine = set(REFINE_SPANS) <= set(totals["spans"])
    assert has_refine == refine
    if refine:
        for name, parent in REFINE_SPANS.items():
            assert totals["spans"][name]["parents"] == [parent]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_counters_equal_the_renders_own_counts(scene, backend):
    init, alive, cams, _ = scene
    # Windows and a global buffer too small for the scene: both cut.
    cfg = model_config(backend, tile_capacity=8, max_intersections=128)
    render = rasterize.render_tiled_pallas if backend == "pallas" \
        else rasterize.render_tiled
    profiling.reset()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        out, meta = render(init["means"], init["quats"],
                           activated_scales(init),
                           activated_opacity(init, alive),
                           rade_gs.compute_colors(init, cams[0], 0, cfg),
                           cams[0], cfg.render, alive_mask=alive)
    c = profiling.totals()["counters"]
    bins = meta.bins
    assert c["render.rows"] == CAP
    assert c["render.alive"] == int(alive.sum()) == N
    assert c["render.pairs"] == int(bins.starts[-1] + bins.dropped) > 0
    assert c["render.spilled"] == int(out.spilled) > 0


class _HostValues(TorchDispatchMode):
    """Counts the tensors made from host values (``torch.tensor(data)``,
    a Python number written into a tensor): on a card each is a copy from
    the host that waits for the queue to drain."""

    def __init__(self):
        super().__init__()
        self.made = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.lift_fresh.default,
                    torch.ops.aten.lift_fresh_copy.default):
            self.made += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_the_step_copies_no_host_value_to_the_device(scene, sh_degree):
    """The step's only waits for the card are its ``sync.*`` reads: SH,
    the viewmat and SSIM make their constants where they are used."""
    init, alive, cams, images = scene
    init = dict(init, features_rest=torch.zeros(
        CAP, (sh_degree + 1) ** 2 - 1, 3))
    model = rade_gs.RadeGSConfig(
        sh_degree=sh_degree, background="random",
        use_depth_normal_loss=True, regularization_from_iter=0,
        render=RenderOptions(tile_capacity=256, max_intersections=1 << 15))
    tr = Trainer(TrainerConfig(
        model=model, strategy=strategy.StrategyConfig(
            warmup_length=NO_REFINE), max_iterations=30_000),
        cams, images, init, alive, device="cpu")
    tr.step = 20_000   # every SH band active
    tr.train_one_step()
    mode = _HostValues()
    with mode:
        tr.train_one_step()
    assert mode.made == 0


@pytest.mark.parametrize("times", [{}, None])
def test_stage_timer_times_and_emits_mesh_spans(times):
    timer = StageTimer(times)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer("tsdf"):
            torch.ones(8).sum()
        with timer("marching"):
            pass
    names = {e.name for e in prof.events()}
    assert {"mesh.tsdf", "mesh.marching"} <= names
    assert set(profiling.totals()["spans"]) == {"mesh.tsdf", "mesh.marching"}
    if times is not None:
        assert set(times) == {"tsdf", "marching"}
        assert all(len(v) == 1 and v[0] >= 0 for v in times.values())


def test_trace_writes_the_totals_beside_the_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as path:
        with profiling.span("outer"):
            with profiling.span("sync.read"):
                profiling.count("items", 2)
                profiling.count("items", torch.tensor(3))
                profiling.count("items", lambda: 4.5)
    totals = json.loads((tmp_path / "t" / "totals.json").read_text())
    assert path.endswith("trace.json")
    assert totals["counters"] == {"items": 9.5, "host_syncs": 1.0}
    assert totals["spans"]["sync.read"]["parents"] == ["outer"]
    assert totals["spans"]["outer"]["count"] == 1
    # Recording stopped with the session, and a new trace starts afresh.
    profiling.count("items", 1)
    assert profiling.totals()["counters"]["items"] == 9.5
    with profiling.trace(str(tmp_path / "u")):
        pass
    assert json.loads((tmp_path / "u" / "totals.json").read_text()) == {
        "spans": {}, "counters": {}}

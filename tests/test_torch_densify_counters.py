"""The refine's and the capacity growth's counters (``utils/profiling.py``):
``refine.duplicated``, ``refine.split`` and ``refine.culled`` add each
refine's counts, ``train.grown_rows`` the rows a growth adds, while a
profiler session records, and nothing otherwise."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collab_splats_tpu_torch.core.options import RenderOptions
from collab_splats_tpu_torch.data.synthetic import (orbit_cameras,
                                                    random_gaussian_params)
from collab_splats_tpu_torch.models import rade_gs
from collab_splats_tpu_torch.models.gaussians import pad_to_capacity
from collab_splats_tpu_torch.train import strategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig
from collab_splats_tpu_torch.utils import profiling

torch.set_num_threads(2)
C = 64


def _table(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"means": torch.randn(C, 3, generator=g),
              "scales": torch.log(0.002 + 0.03 * torch.rand(C, 3,
                                                              generator=g)),
              "quats": torch.randn(C, 4, generator=g),
              "opacities": 3.0 * torch.randn(C, 1, generator=g)}
    alive = torch.rand(C, generator=g) < 0.6
    st = strategy.StrategyState(
        grad_accum=0.004 * torch.rand(C, generator=g),
        count=torch.randint(0, 3, (C,), generator=g).float(),
        max_radii=0.1 * torch.rand(C, generator=g))
    return params, alive, st


@pytest.mark.parametrize("seed, flags", [
    (0, {}), (1, {"scale_cull": True, "screen_size_cull": True}),
    (2, {"allow_split": False, "allow_dup": False})])
def test_refine_counters_add_the_refines_counts(seed, flags):
    params, alive, st = _table(seed)
    cfg = strategy.StrategyConfig()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        res = [strategy.refine(params, alive, st, cfg,
                               torch.Generator().manual_seed(seed), **flags)
               for _ in range(2)]
    c = profiling.totals()["counters"]
    assert c["refine.duplicated"] == 2 * int(res[0].n_dup)
    assert c["refine.split"] == 2 * int(res[0].n_split)
    assert c["refine.culled"] == 2 * int(res[0].n_cull)
    assert int(res[0].n_dup) + int(res[0].n_split) + int(res[0].n_cull) > 0
    # Off, nothing is recorded.
    profiling.reset()
    strategy.refine(params, alive, st, cfg, torch.Generator().manual_seed(0))
    assert profiling.totals()["counters"] == {}


def test_capacity_growth_counts_its_rows():
    """200 alive rows in 256: the first refine's capacity check doubles
    the table (200 x 1.5 > 256), once."""
    n, cap = 200, 256
    gt = random_gaussian_params(torch.Generator().manual_seed(0), n,
                                extent=0.6, scale_range=(0.02, 0.08),
                                device="cpu")
    cams = orbit_cameras(2, radius=2.5, width=32, height=32, focal=35.2,
                         device="cpu")
    model = rade_gs.RadeGSConfig(
        sh_degree=0, background="black", use_depth_normal_loss=False,
        render=RenderOptions(tile_capacity=256, max_intersections=1 << 15))
    images = [torch.rand(32, 32, 3, generator=torch.Generator()
                         .manual_seed(i)) for i in range(2)]
    conf = TrainerConfig(model=model, max_iterations=200,
                         strategy=strategy.StrategyConfig(
                             warmup_length=0, refine_every=2,
                             stop_split_at=0))
    tr = Trainer(conf, cams, images, pad_to_capacity(gt, cap),
                 torch.arange(cap) < n, device="cpu")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            tr.train_one_step()
    c = profiling.totals()["counters"]
    assert tr.alive.shape[0] == 2 * cap
    assert c["train.grown_rows"] == cap
    assert c["refine.duplicated"] == c["refine.split"] == 0
    # Cull-only refines: every row they take away is counted.
    assert c["refine.culled"] == n - int(tr.alive.sum())

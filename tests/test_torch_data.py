"""The port's data layer and method registry against the JAX package's.

PLY I/O both ways; ``parse_transforms_json`` and ``FullImageDatamanager``
on a dataset written by JAX ``data/synthetic.py::write_synthetic_dataset``
(cameras within 1e-6, images, points and the train/eval split equal, with
and without a downscale); ``Camera.downscaled`` and the trainer's
progressive resolution (``downscale_factor`` and the box-filtered ground
truth, odd sizes included, as tests/test_data.py:147 holds JAX to) against
JAX's; ``get_method`` for the four registered methods.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collab_splats_tpu.core.cameras import make_camera as jmake_camera
from collab_splats_tpu.core.options import RenderOptions as JOpts
from collab_splats_tpu.data import datamanager as jdm
from collab_splats_tpu.data import dataparser as jdp
from collab_splats_tpu.data import ply as jply
from collab_splats_tpu.data.synthetic import write_synthetic_dataset
from collab_splats_tpu.models import rade_gs as jrade
from collab_splats_tpu.pipeline import methods as jmethods
from collab_splats_tpu.train import strategy as jstrategy
from collab_splats_tpu.train.trainer import Trainer as JTrainer
from collab_splats_tpu.train.trainer import TrainerConfig as JConfig
from collab_splats_tpu_torch.core.cameras import make_camera
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.data import datamanager as tdm
from collab_splats_tpu_torch.data import dataparser as tdp
from collab_splats_tpu_torch.data import ply as tply
from collab_splats_tpu_torch.models import rade_gs as trade
from collab_splats_tpu_torch.models.gaussians import params_from_numpy
from collab_splats_tpu_torch.pipeline import methods as tmethods
from collab_splats_tpu_torch.train import strategy as tstrategy
from collab_splats_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_core import both_cameras, numpy_scene

torch.set_num_threads(2)


@pytest.mark.parametrize("writer,reader", [(tply, tply), (jply, tply),
                                           (tply, jply)],
                         ids=["port", "jax-to-port", "port-to-jax"])
def test_ply_roundtrip(tmp_path, writer, reader):
    rng = np.random.RandomState(0)
    pts = rng.randn(100, 3).astype(np.float32)
    cols = rng.rand(100, 3).astype(np.float32)
    normals = rng.randn(100, 3).astype(np.float32)
    faces = rng.randint(0, 100, (20, 3)).astype(np.int32)
    writer.write_ply(str(tmp_path / "a.ply"), pts, colors=cols,
                     normals=normals, faces=faces)
    out = reader.read_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(out["points"], pts)
    np.testing.assert_array_equal(out["normals"], normals)
    np.testing.assert_array_equal(out["faces"], faces)
    np.testing.assert_allclose(out["colors"], cols, atol=1 / 255.0)


def test_ply_ascii(tmp_path):
    path = tmp_path / "b.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\n"
                    "property uchar blue\nend_header\n"
                    "0 1 2 255 0 0\n3 4 5 0 255 0\n")
    got, ref = tply.read_ply(str(path)), jply.read_ply(str(path))
    assert set(got) == set(ref) == {"points", "colors"}
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    out_dir, _, _ = write_synthetic_dataset(d, n_cams=4, n_gaussians=100,
                                            width=48, height=48)
    return out_dir / "transforms.json"


def assert_cameras_match(tcams, jcams):
    assert len(tcams) == len(jcams)
    for t, j in zip(tcams, jcams):
        assert (t.width, t.height) == (j.width, j.height)
        assert t.K.device.type == "cpu"
        np.testing.assert_allclose(t.K.numpy(), np.asarray(j.K), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(t.c2w.numpy(), np.asarray(j.c2w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("kw", [
    {}, {"downscale_factor": 2}, {"auto_scale": False, "orient_center": False},
    {"train_split_fraction": 0.7}, {"train_split_fraction": 0.5}],
    ids=["default", "downscale", "raw", "split-0.7", "split-0.5"])
def test_parse_transforms_json_matches(dataset, kw):
    got = tdp.parse_transforms_json(dataset, device="cpu", **kw)
    ref = jdp.parse_transforms_json(dataset, **kw)
    assert_cameras_match(got.train_cameras, ref.train_cameras)
    assert_cameras_match(got.eval_cameras, ref.eval_cameras)
    assert got.train_image_paths == ref.train_image_paths
    assert got.eval_image_paths == ref.eval_image_paths
    n_eval = {0.7: 1, 0.5: 2}.get(kw.get("train_split_fraction"), 0)
    assert len(got.eval_cameras) == n_eval
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.point_colors, ref.point_colors)
    np.testing.assert_array_equal(got.transform, ref.transform)
    assert got.scale == ref.scale and got.scene_scale == ref.scene_scale


@pytest.mark.parametrize("factor", [1, 2])
def test_datamanager_matches(dataset, factor):
    got = tdm.FullImageDatamanager.from_transforms_json(
        dataset, downscale_factor=factor, train_split_fraction=0.7,
        device="cpu")
    ref = jdm.FullImageDatamanager.from_transforms_json(
        dataset, downscale_factor=factor, train_split_fraction=0.7)
    assert len(got) == len(ref) == 3 and len(got.eval_images) == 1
    for a, b in zip(got.train_images + got.eval_images,
                    ref.train_images + ref.eval_images):
        assert a.dtype == np.uint8 and a.shape == (48 // factor,) * 2 + (3,)
        np.testing.assert_array_equal(a, b)
    assert_cameras_match(got.train_cameras, ref.train_cameras)
    np.testing.assert_array_equal(got.points, ref.points)
    assert got.scene_scale == ref.scene_scale
    for step in range(3):
        (tc, tb, ti) = got.next_train(step, np.random.RandomState(step))
        (jc, jb, ji) = ref.next_train(step, np.random.RandomState(step))
        assert ti == ji
        np.testing.assert_array_equal(tb["image"], jb["image"])
    (tc, tb), (jc, jb) = got.next_eval(0), ref.next_eval(0)
    assert_cameras_match([tc], [jc])
    np.testing.assert_array_equal(tb["image"], jb["image"])
    assert tb["image"].dtype == np.float32


def test_load_image_matches(dataset):
    scene = tdp.parse_transforms_json(dataset, device="cpu")
    path = scene.train_image_paths[0]
    for factor in (1, 2, 3):
        np.testing.assert_array_equal(tdp.load_image(path, factor),
                                      jdp.load_image(path, factor))


def test_odd_dimensions_downscale_consistency(tmp_path):
    """The camera's size floor-divides as load_image's resize does."""
    from PIL import Image

    w, h = 99, 77
    (tmp_path / "images").mkdir()
    frames = []
    for i in range(3):
        name = f"im{i}.png"
        Image.fromarray(np.random.RandomState(i).randint(
            0, 255, (h, w, 3), np.uint8)).save(tmp_path / "images" / name)
        frames.append({"file_path": f"images/{name}",
                       "transform_matrix": np.eye(4).tolist(),
                       "w": w, "h": h, "fl_x": 80.0, "fl_y": 80.0,
                       "cx": w / 2, "cy": h / 2})
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump({"frames": frames}, f)
    for factor in (2, 4):
        scene = tdp.parse_transforms_json(tmp_path / "transforms.json",
                                          downscale_factor=factor,
                                          device="cpu")
        img = tdp.load_image(scene.train_image_paths[0], factor)
        cam = scene.train_cameras[0]
        assert (cam.height, cam.width) == img.shape[:2]


@pytest.mark.parametrize("size", [(64, 48), (99, 77), (37, 50)])
def test_camera_downscaled_matches(size):
    w, h = size
    c2w = np.eye(4, dtype=np.float32)
    j = jmake_camera(90.0, 80.0, w / 2, h / 2, w, h, jnp.asarray(c2w))
    t = make_camera(90.0, 80.0, w / 2, h / 2, w, h, c2w, device="cpu")
    for factor in (1, 2, 4):
        assert_cameras_match([t.downscaled(factor)], [j.downscaled(factor)])
    assert t.downscaled(1) is t
    np.testing.assert_array_equal(t.K.numpy()[:, 2], [w / 2, h / 2, 1.0])


def test_downscale_factor_matches():
    for n, sched in ((0, 3000), (2, 3000), (3, 5), (2, 0)):
        conf = TrainerConfig(num_downscales=n, resolution_schedule=sched)
        jconf = JConfig(num_downscales=n, resolution_schedule=sched)
        for step in (0, 1, 4, 5, 9, 10, 15, 2999, 3000, 6000, 9000):
            got = Trainer.downscale_factor(
                SimpleNamespace(config=conf, step=step))
            ref = JTrainer.downscale_factor(
                SimpleNamespace(config=jconf, step=0), step)
            assert got == ref, (n, sched, step)


def box_filter_reference(image, h, w, d):
    """The JAX trainer's box filter of the ground truth
    (collab_splats_tpu/train/trainer.py:161-168)."""
    return jnp.asarray(image)[:h * d, :w * d].reshape(
        h, d, w, d, -1).mean(axis=(1, 3))


def test_progressive_resolution_matches_jax(monkeypatch):
    """Three steps at num_downscales=2 and a schedule of 1 (factors 4, 2,
    1) at an odd size: the camera sizes and the box-filtered ground truth
    each step renders against, and the history, against the JAX
    trainer's."""
    w, h = 53, 45
    p, K, c2w = numpy_scene(300, seed=41, width=w, height=h)
    image = np.random.default_rng(42).uniform(0, 1, (h, w, 3)).astype(
        np.float32)
    opts = dict(rasterize_mode="antialiased", tile_capacity=128,
                max_intersections=1 << 14)
    kw = dict(num_downscales=2, resolution_schedule=1)
    jtr = JTrainer(JConfig(model=jrade.RadeGSConfig(
        sh_degree=0, background="black", use_depth_normal_loss=False,
        render=JOpts(**opts)), strategy=jstrategy.StrategyConfig(
            warmup_length=10 ** 7), **kw),
        [both_cameras(K, c2w, w, h)[0]], [image],
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.ones(300, bool))
    tr = Trainer(TrainerConfig(model=trade.RadeGSConfig(
        sh_degree=0, background="black", use_depth_normal_loss=False,
        render=TOpts(**opts)), strategy=tstrategy.StrategyConfig(
            warmup_length=10 ** 7), **kw),
        [both_cameras(K, c2w, w, h)[1]], [image],
        params_from_numpy(p, device="cpu"), torch.ones(300, dtype=torch.bool),
        device="cpu")
    seen = []
    real = trade.get_loss

    def get_loss(outputs, gt, *args, **kwargs):
        seen.append((tuple(outputs["rgb"].shape), gt.detach().clone()))
        return real(outputs, gt, *args, **kwargs)

    monkeypatch.setattr(trade, "get_loss", get_loss)
    for d in (4, 2, 1):
        assert tr.downscale_factor() == jtr.downscale_factor() == d
        th, jh = tr.train_one_step(), jtr.train_one_step()
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-3, err_msg=k)
        shape, gt = seen[-1]
        assert shape == (h // d, w // d, 3) == tuple(gt.shape)
        np.testing.assert_allclose(
            gt.numpy(), np.asarray(box_filter_reference(image, h // d, w // d,
                                                        d)),
            rtol=0, atol=1e-6)
    # Evaluation stays at full resolution.
    monkeypatch.undo()
    ev = tr.eval_image(tr.cameras[0], image)
    assert np.isfinite(ev["psnr"])


@pytest.mark.parametrize("name", ["rade-gs", "splatfacto", "rade-features",
                                  "feature-splatting"])
def test_get_method_matches(name):
    got, ref = tmethods.get_method(name), jmethods.get_method(name)
    assert (got.name, got.has_features) == (ref.name, ref.has_features)
    assert got.groups.keys() == ref.groups.keys()
    for k, spec in got.groups.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref.groups[k])
    dims = (("clip-vit", (768, 36, 64)), ("dinov2", (384, 36, 64)))
    kw = {"feature_dims": dims} if got.has_features else {}
    tc, jc = got.make_trainer_config(**kw), ref.make_trainer_config(**kw)
    for f in dataclasses.fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if dataclasses.is_dataclass(a):
            b = {k: v for k, v in dataclasses.asdict(b).items()
                 if k in dataclasses.asdict(a) and k != "render"}
            a = {k: v for k, v in dataclasses.asdict(a).items() if k in b}
        assert a == b, f.name
    assert tc.model.render.rasterize_mode == jc.model.render.rasterize_mode
    assert type(tc.model).__name__ == type(jc.model).__name__
    with pytest.raises(ValueError, match="Unknown method"):
        tmethods.get_method("nope")

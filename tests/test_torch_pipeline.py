"""The port's pipeline against the JAX package's, on the CPU.

* The JAX-free copies (``pipeline/config.py``, ``colmap.py``, ``hloc.py``,
  ``equirect.py``) give the JAX functions' results on the same inputs, as
  tests/test_pipeline.py, test_colmap.py (parsing and the pose round trip;
  the SfM run stays JAX's) and test_equirect.py check them.
* The PNG codec (``data/png.py``) decodes PIL's files (PIL writes Sub and
  Paeth rows for RGB/RGBA, Up for greyscale) to PIL's pixels bit for bit,
  and PIL decodes the codec's files of every filter type to the pixels.
* The turbo table (``utils/colormaps.py``) equals
  ``matplotlib.colormaps["turbo"]``.
* The whole slice: the JAX ``Splatter`` trains rade-features (hash-proj
  maps) on a 48x48 synthetic dataset (written by the port's
  ``write_synthetic_dataset``) for ten steps and meshes it, once.
  The port's ``Splatter`` on a copy of that output loads the checkpoint to
  the same bits, its viewer's render (1e-4 in the depth mode, which
  spreads depth over [0, 1]) and its ``query_mesh`` come within 1e-5 of
  max|ref| of JAX's (the query's PLY colours equal JAX's matplotlib
  colours wherever the similarities fall in the same turbo entry), and
  its ``mesh(overwrite=True)`` matches JAX's mesh within the meshing
  tolerances of tests/test_torch_meshing.py (vertex count within
  2%, Chamfer at most 0.25 voxel, attributes within 1e-4 at matched
  vertices).  The port's own ``run_pipeline`` raises PSNR and resumes an
  interrupted run to the bits of an uninterrupted one; ``mesh()`` takes
  the level-set mesher and rejects an unknown one; its CLI runs the
  stages and lists the methods as JAX's does; ``from_config_file`` builds
  JAX's stages; the host mesh painter and the camera frusta equal JAX's.
"""

import io
import json
import shutil
import struct
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from collab_splats_tpu.pipeline import cli as jcli
from collab_splats_tpu.pipeline import colmap as jcolmap
from collab_splats_tpu.pipeline import config as jconfig
from collab_splats_tpu.pipeline import equirect as jequirect
from collab_splats_tpu.pipeline.splatter import Splatter as JSplatter
from collab_splats_tpu.pipeline.viewer import SplatViewer as JViewer
from collab_splats_tpu_torch.core.cameras import camera_from_numpy
from collab_splats_tpu_torch.core.options import RenderOptions as TOpts
from collab_splats_tpu_torch.data import png
from collab_splats_tpu_torch.data.dataparser import load_image_uint8
from collab_splats_tpu_torch.data.ply import read_ply
from collab_splats_tpu_torch.data.synthetic import write_synthetic_dataset
from collab_splats_tpu_torch.models import rade_gs as trade
from collab_splats_tpu_torch.models.gaussians import init_from_points
from collab_splats_tpu_torch.pipeline import cli, colmap, config, equirect
from collab_splats_tpu_torch.pipeline import hloc
from collab_splats_tpu_torch.pipeline.splatter import Splatter, ValidationError
from collab_splats_tpu_torch.pipeline.viewer import SplatViewer
from collab_splats_tpu_torch.train import losses
from collab_splats_tpu_torch.utils.colormaps import turbo
from test_torch_meshing import assert_meshes_match

torch.set_num_threads(2)

# ---------------------------------------------------------------- config


def test_deep_merge_and_overrides():
    base = {"a": 1, "b": {"c": 2, "d": 3}}
    over = {"b": {"c": 9}, "e": 5}
    assert config.deep_merge(base, over) == jconfig.deep_merge(base, over)
    assert base["b"]["c"] == 2
    args = ["method=rade-gs", "preprocess.sfm_tool=colmap",
            "training.max_iterations=100", "meshing.voxel_size=0.02",
            "flag=true", "other=False", "name=x=y"]
    assert config.parse_cli_overrides(args) == \
        jconfig.parse_cli_overrides(args)
    with pytest.raises(ValueError):
        config.parse_cli_overrides(["novalue"])


def test_loader_hierarchy(tmp_path):
    (tmp_path / "datasets").mkdir()
    (tmp_path / "base.yaml").write_text(
        "method: rade-features\ntraining:\n  max_iterations: 30000\n")
    (tmp_path / "datasets" / "ants.yaml").write_text(
        "file_path: /data/ants.mp4\ntraining:\n  max_iterations: 100\n")
    loader, jloader = config.ConfigLoader(tmp_path), \
        jconfig.ConfigLoader(tmp_path)
    assert loader.list_datasets() == jloader.list_datasets() == ["ants"]
    over = {"method": "rade-gs"}
    assert loader.load("ants", overrides=over) == \
        jloader.load("ants", overrides=over)
    with pytest.raises(ValueError):
        loader.load("nonexistent")


def test_splatter_validation(tmp_path):
    with pytest.raises(ValidationError):
        Splatter({"method": "rade-gs"}, device="cpu")
    with pytest.raises(ValidationError):
        Splatter({"file_path": str(tmp_path), "method": "nerf"},
                 device="cpu")
    d = tmp_path / "videos" / "scene"
    d.mkdir(parents=True)
    s = Splatter({"file_path": str(d), "method": "rade-gs"}, device="cpu")
    assert s.config["output_path"] == JSplatter(
        {"file_path": str(d), "method": "rade-gs"}).config["output_path"]


# ---------------------------------------------------------------- colmap
def write_model(tmp):
    """tests/test_colmap.py's model: four COLMAP cameras around a target."""
    from test_colmap import _write_model

    return _write_model(tmp)


def test_colmap_parsers(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "1 SIMPLE_RADIAL 100 80 90 50 40 0.01\n"
        "2 OPENCV 640 480 500 510 320 240 0.1 -0.05 0.001 0.002\n")
    assert colmap.parse_cameras_txt(tmp_path / "cameras.txt") == \
        jcolmap.parse_cameras_txt(tmp_path / "cameras.txt")
    write_model(tmp_path)
    got = colmap.parse_images_txt(tmp_path / "images.txt")
    ref = jcolmap.parse_images_txt(tmp_path / "images.txt")
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(colmap.parse_points3d_txt(tmp_path / "points3D.txt"),
                    jcolmap.parse_points3d_txt(tmp_path / "points3D.txt")):
        np.testing.assert_array_equal(a, b)
    q = np.array([0.9, 0.1, -0.3, 0.2])
    np.testing.assert_array_equal(colmap.qvec2rotmat(q),
                                  jcolmap.qvec2rotmat(q))


def test_colmap_pose_round_trip(tmp_path):
    """transforms.json and the sparse PLY from one TXT model equal the JAX
    package's; the port's dataparser then projects world points as the
    COLMAP cameras do (nerfstudio's world permutation applied)."""
    from collab_splats_tpu_torch.data.dataparser import parse_transforms_json

    poses = write_model(tmp_path)
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    colmap.write_dataset_outputs(tmp_path, tmp_path / "images",
                                 tmp_path / "port")
    jcolmap.write_dataset_outputs(tmp_path, tmp_path / "images",
                                  tmp_path / "jax")
    assert json.loads((tmp_path / "port" / "transforms.json").read_text()) \
        == json.loads((tmp_path / "jax" / "transforms.json").read_text())
    assert (tmp_path / "port" / "sparse_points.ply").read_bytes() == \
        (tmp_path / "jax" / "sparse_points.ply").read_bytes()
    P = np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1.0]])
    scene = parse_transforms_json(
        tmp_path / "port" / "transforms.json", auto_scale=False,
        orient_center=False, train_split_fraction=1.0, device="cpu")
    X = np.array([0.3, -0.2, 0.5])
    for (R, t), camera in zip(poses, scene.train_cameras):
        w2c = camera.viewmat().numpy()
        np.testing.assert_allclose(w2c[:3, :3] @ (P @ X) + w2c[:3, 3],
                                   R @ X + t, atol=1e-5)


def test_sfm_gates(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not colmap.colmap_available()
    with pytest.raises(ValidationError, match="COLMAP"):
        Splatter._run_sfm(tmp_path, tmp_path, "colmap")
    with pytest.raises(ValidationError, match="hloc"):
        Splatter._run_sfm(tmp_path, tmp_path, "hloc")
    if not hloc.hloc_available():
        with pytest.raises(hloc.HlocError, match="hloc"):
            hloc.run_hloc_sfm(tmp_path, tmp_path)


# -------------------------------------------------------------- equirect
def test_equirect_matches():
    from test_equirect import _latlon_pano

    pano = _latlon_pano()
    assert equirect.VIEW_DIRECTIONS == jequirect.VIEW_DIRECTIONS
    for yaw, pitch in [(0, 0), (90, 0), (180, 0), (0, 45), (0, 90)]:
        np.testing.assert_array_equal(
            equirect.equirect_to_perspective(pano, yaw, pitch, 90.0, 64),
            jequirect.equirect_to_perspective(pano, yaw, pitch, 90.0, 64))
    pano8 = (np.random.RandomState(0).rand(64, 128, 3) * 255).astype(
        np.uint8)
    for a, b in zip(equirect.generate_planar_projections(pano8, out_size=32),
                    jequirect.generate_planar_projections(pano8,
                                                          out_size=32)):
        np.testing.assert_array_equal(a, b)


def test_crop_equirect_dir_matches(tmp_path):
    src = tmp_path / "scene_360"
    src.mkdir()
    pano = (np.random.RandomState(1).rand(64, 128, 3) * 255).astype(np.uint8)
    Image.fromarray(pano).save(src / "pano0.png")
    assert equirect.crop_equirect_dir(src, tmp_path / "port") == \
        jequirect.crop_equirect_dir(src, tmp_path / "jax") == 14
    for f in sorted((tmp_path / "jax").glob("*.png")):
        np.testing.assert_array_equal(
            png.read_png(tmp_path / "port" / f.name), png.read_png(f))


# ------------------------------------------------------------------- PNG
def png_filters(data: bytes):
    """The filter types of a PNG's rows."""
    off, idat = 8, []
    while off < len(data):
        (length,) = struct.unpack_from(">I", data, off)
        kind, body = data[off + 4:off + 8], data[off + 8:off + 8 + length]
        off += 12 + length
        if kind == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat.append(body)
    raw = zlib.decompress(b"".join(idat))
    stride = w * {0: 1, 2: 3, 6: 4}[ctype] + 1
    return {raw[y * stride] for y in range(h)}


def seeded_image(seed, channels, h=37, w=53):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    planes = [(xx * 3 + yy) % 256, (yy * 5) % 256,
              (rng.integers(0, 40, (h, w)) + xx) % 256,
              rng.integers(0, 256, (h, w))][:channels]
    return np.stack(planes, -1).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["L", "RGB", "RGBA"])
def test_png_decodes_pil(channels, tmp_path):
    img = seeded_image(channels, channels)
    pil = Image.fromarray(img[..., 0] if channels == 1 else img)
    buf = io.BytesIO()
    pil.save(buf, "PNG")
    data = buf.getvalue()
    assert len(png_filters(data)) >= 2
    got = png.decode_png(data)
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    (tmp_path / "a.png").write_bytes(data)
    np.testing.assert_array_equal(
        load_image_uint8(tmp_path / "a.png"),
        np.asarray(Image.open(tmp_path / "a.png").convert("RGB")))


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [3, 4], ids=["RGB", "RGBA"])
def test_png_encodes_for_pil(filter_type, channels):
    img = seeded_image(10 + filter_type, channels)
    data = png.encode_png(img, filter_type)
    assert png_filters(data) == {filter_type}
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_turbo_matches_matplotlib():
    import matplotlib

    x = np.random.default_rng(11).uniform(-0.1, 1.1, 5000).astype(
        np.float32)
    x[:4] = [0.0, 1.0, 0.5, np.nan]
    ref = matplotlib.colormaps["turbo"]
    np.testing.assert_array_equal(turbo(x), ref(x))
    np.testing.assert_array_equal(turbo(x.astype(np.float64)),
                                  ref(x.astype(np.float64)))


# ---------------------------------------------------------- the whole slice
TRAINING = {"max_iterations": 10, "capacity": 512, "num_downscales": 0,
            "extractors": ("hash-proj",), "feature_type": "hash-proj",
            "final_resolution": 16}
MESHING = {"voxel_size": 0.05, "depth_trunc": 4.0, "align_floor": False,
           "max_dim": 64}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Splatter's rade-features run on a 48x48 dataset, meshed."""
    d = tmp_path_factory.mktemp("pipeline")
    # The dataset is input to both packages; the port writes it (the JAX
    # writer renders eagerly, about 30 s on the CPU).
    write_synthetic_dataset(d / "input", n_cams=8, n_gaussians=120,
                            width=48, height=48, device="cpu")
    s = JSplatter({"file_path": str(d / "input"), "method": "rade-features",
                   "output_path": str(d / "jax")})
    s._training_config = dict(TRAINING)
    s._meshing_config = dict(MESHING)
    s.run_pipeline()
    s._loaded = None
    return d, s


@pytest.fixture(scope="module")
def port_copy(jax_run):
    """The port's Splatter on a copy of the JAX run's output."""
    d, _ = jax_run
    shutil.copytree(d / "jax", d / "port")
    s = Splatter({"file_path": str(d / "input"), "method": "rade-features",
                  "output_path": str(d / "port")}, device="cpu")
    return d, s


def test_load_model_same_bits(jax_run, port_copy):
    _, js = jax_run
    _, s = port_copy
    jstep, jparams, jalive, _, jcfg = js.load_model()
    step, params, alive, _, cfg, decoder = s.load_model()
    assert step == jstep == TRAINING["max_iterations"]
    assert torch.equal(alive, torch.from_numpy(np.array(jalive)))
    assert set(params) | {"decoder"} == set(jparams)
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]), k)
    from collab_splats_tpu_torch.features import decoder as tdec

    for k, v in tdec.decoder_to_numpy(decoder).items():
        np.testing.assert_array_equal(v, np.asarray(jparams["decoder"][k]))
    assert cfg.feature_dims == jcfg.feature_dims
    assert cfg.main_feature_name == jcfg.main_feature_name == "hash-proj"


def test_viewer_render_matches(jax_run, port_copy, monkeypatch):
    _, js = jax_run
    _, s = port_copy
    # JAX's viewer renders eagerly (about 15 s a view on the CPU): its
    # render runs through the JAX trainer's jitted eval render instead.
    import collab_splats_tpu.utils.visualization as jvis
    from collab_splats_tpu.train.trainer import Trainer as JTrainer

    monkeypatch.setattr(jvis.rade_gs, "get_outputs", JTrainer._eval_outputs)
    _, jparams, jalive, _, jcfg = js.load_model()
    _, params, alive, _, cfg, _ = s.load_model()
    jv = JViewer(jparams, jalive, jcfg, width=64, height=48)
    v = SplatViewer(params, alive, cfg, width=64, height=48, device="cpu")
    # The depth mode spreads the depth map over [0, 1]: it is held within
    # 1e-4, the depth tolerance of tests/test_render.py:269.
    for mode, tol in (("rgb", 1e-5), ("depth", 1e-4)):
        ref = jv.render(0.7, 0.4, 2.5, mode)
        got = v.render(0.7, 0.4, 2.5, mode)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * np.abs(ref).max(),
                                   err_msg=mode)


def test_query_mesh_matches(jax_run, port_copy):
    d, js = jax_run
    _, s = port_copy
    ref = js.query_mesh(["red disk"], ["object"],
                        output_fn=d / "jax_query.ply")
    got = s.query_mesh(["red disk"], ["object"],
                       output_fn=d / "port_query.ply")
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    a, b = read_ply(str(d / "port_query.ply")), \
        read_ply(str(d / "jax_query.ply"))
    np.testing.assert_array_equal(a["faces"], b["faces"])
    # Colours are stored as uint8: equal where the similarities round to
    # the same turbo entry.
    same = np.floor(np.clip(got, 0, 1) * 256) == \
        np.floor(np.clip(ref, 0, 1) * 256)
    assert same.mean() > 0.99
    np.testing.assert_array_equal(a["colors"][same], b["colors"][same])


def test_mesh_matches(jax_run, port_copy):
    """The port's TSDF export of the JAX run's checkpoint against JAX's
    (run after the query, which reads the copied mesh)."""
    d, js = jax_run
    _, s = port_copy
    from collab_splats_tpu_torch.meshing.exporters import TSDFExporterConfig
    from collab_splats_tpu_torch.meshing.tsdf import volume_from_bounds

    got = s.mesh(overwrite=True, **MESHING)
    ref = np.load(d / "jax" / "mesh" / "mesh_features.npz")
    jmesh = read_ply(str(d / "jax" / "mesh" / "mesh.ply"))
    _, params, alive, _, _, _ = s.load_model()
    pts = params["means"][alive].numpy()
    cfg = TSDFExporterConfig(**MESHING)
    tcfg, _ = volume_from_bounds(pts.min(0) - 0.1, pts.max(0) + 0.1,
                                 cfg.voxel_size, cfg.sdf_trunc,
                                 cfg.depth_trunc, max_dim=cfg.max_dim,
                                 device="cpu")
    assert_meshes_match(got["vertices"], got["faces"], jmesh["points"],
                        jmesh["faces"], tcfg.voxel_size,
                        [(got["features"], ref["features"])])
    # The second call skips and returns a fresh export's keys.
    again = s.mesh(**MESHING)
    assert set(again) == {"vertices", "faces", "colors"}
    np.testing.assert_array_equal(again["faces"], got["faces"])


def eval_psnr(s, params, alive, cfg):
    """PSNR of the model on the dataset's first training view."""
    from collab_splats_tpu_torch.data.datamanager import FullImageDatamanager

    dm = FullImageDatamanager.from_transforms_json(
        s.preproc_dir / "transforms.json", device="cpu")
    with torch.no_grad():
        out, _ = trade.get_outputs(params, alive, dm.train_cameras[0], 0, cfg,
                                   training=False)
    return float(losses.psnr(out["rgb"], torch.from_numpy(
        dm.train_images[0].astype(np.float32) / 255.0)))


def port_splatter(d, name, **training):
    s = Splatter({"file_path": str(d / "input"), "method": "rade-gs",
                  "output_path": str(d / name)}, device="cpu")
    s._training_config = {"capacity": 512, "sh_degree": 0,
                          "num_downscales": 0, **training}
    s._meshing_config = dict(MESHING)
    return s


def test_run_pipeline_raises_psnr_and_resumes(jax_run):
    d, _ = jax_run
    s = port_splatter(d, "port_run", max_iterations=30, background="black")
    s.run_pipeline()
    assert (s.mesh_dir / "mesh.ply").exists()
    step, params, alive, _, cfg, decoder = s.load_model()
    assert step == 30 and decoder is None
    from collab_splats_tpu_torch.data.datamanager import FullImageDatamanager

    dm = FullImageDatamanager.from_transforms_json(
        s.preproc_dir / "transforms.json", device="cpu")
    init, ialive = init_from_points(dm.points, dm.point_colors,
                                    torch.Generator().manual_seed(42),
                                    sh_degree=0, capacity=512, device="cpu")
    assert eval_psnr(s, params, alive, cfg) > \
        eval_psnr(s, init, ialive, cfg) + 1.0
    # An interrupted run: ten steps, then asked for twenty, against twenty
    # at once.
    a = port_splatter(d, "port_resumed")
    a.preprocess()
    a.train(max_iterations=10)
    a._loaded = None
    a.train(max_iterations=20)
    assert len(a._runs()) == 1
    b = port_splatter(d, "port_whole")
    b.preprocess()
    b.train(max_iterations=20)
    a._loaded = b._loaded = None
    pa, pb = a.load_model(), b.load_model()
    assert pa[0] == pb[0] == 20
    for k, v in pa[1].items():
        assert torch.equal(v, pb[1][k]), k
    # A finished run is skipped.
    assert a.train(max_iterations=20) == a._runs()[-1]


def test_cli(jax_run, capsys):
    d, _ = jax_run
    assert cli.main(["--list-methods"]) == 0
    out = capsys.readouterr().out
    assert jcli.main(["--list-methods"]) == 0
    assert capsys.readouterr().out == out
    argv = ["--input", str(d / "input"), "--method", "splatfacto",
            "--output", str(d / "port_cli"),
            "--set", "training.max_iterations=6",
            "--set", "training.capacity=512",
            "--set", "training.sh_degree=0",
            "--set", "meshing.voxel_size=0.06",
            "--set", "meshing.align_floor=false",
            "--set", "meshing.max_dim=48", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert (d / "port_cli" / "mesh" / "mesh.ply").exists()
    capsys.readouterr()
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    for stage in ("transforms.json exists", "checkpoints exist",
                  "mesh exists"):
        assert stage in out, stage
    assert cli.main([]) == 2


def test_viewer_serves_the_render(jax_run, port_copy):
    _, s = port_copy
    v = s.viewer(port=0, blocking=False, width=64, height=48)
    try:
        port = v._server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        assert b"viewer" in urllib.request.urlopen(base + "/",
                                                   timeout=30).read()
        data = urllib.request.urlopen(
            base + "/render?theta=0.5&phi=0.4&r=3&mode=rgb",
            timeout=120).read()
        img = png.decode_png(data)
        want = (np.clip(v.render(0.5, 0.4, 3.0), 0, 1) * 255).astype(
            np.uint8)
        np.testing.assert_array_equal(img, want)
        info = json.loads(urllib.request.urlopen(base + "/info",
                                                 timeout=30).read())
        assert info["num_gaussians"] == int(s.load_model()[2].sum())
    finally:
        v.shutdown()


def test_write_synthetic_dataset(tmp_path):
    """The port's dataset writer: the JAX package's layout, its PNGs read
    back to the render's pixels, its sparse PLY the scene's means; a given
    scene writes only its alive means."""
    out, gt, cams = write_synthetic_dataset(
        tmp_path, n_cams=3, n_gaussians=50, width=32, height=24,
        device="cpu")
    meta = json.loads((out / "transforms.json").read_text())
    assert [f["file_path"] for f in meta["frames"]] == [
        f"images/frame_{i:05d}.png" for i in range(3)]
    assert meta["w"] == 32 and meta["h"] == 24
    assert meta["fl_x"] == 1.1 * 32
    ply = read_ply(str(out / "sparse.ply"))
    np.testing.assert_array_equal(ply["points"], gt["means"].numpy())
    alive = torch.arange(50) % 3 != 0
    given, _, _ = write_synthetic_dataset(
        tmp_path / "given", n_cams=1, width=32, height=24,
        scene=(gt, alive), device="cpu")
    np.testing.assert_array_equal(
        read_ply(str(given / "sparse.ply"))["points"],
        gt["means"][alive].numpy())
    img = png.read_png(out / meta["frames"][1]["file_path"])
    cfg = trade.RadeGSConfig(
        sh_degree=0, background="black",
        render=TOpts(tile_capacity=256, max_intersections=1 << 16))
    cam = camera_from_numpy(cams[1].K.numpy(), np.asarray(
        meta["frames"][1]["transform_matrix"], np.float32), 32, 24,
        device="cpu")
    with torch.no_grad():
        rgb, _ = trade.get_outputs(gt, torch.ones(50, dtype=torch.bool), cam,
                                   0, cfg, training=False)
    want = (torch.clamp(rgb["rgb"], 0, 1) * 255).to(torch.uint8).numpy()
    assert img.shape == (24, 32, 3)
    np.testing.assert_array_equal(img, want)


def test_from_config_file_matches(tmp_path):
    """A dataset config with overrides builds the JAX Splatter's stages."""
    (tmp_path / "datasets").mkdir()
    (tmp_path / "scene").mkdir()
    (tmp_path / "base.yaml").write_text(
        "method: rade-gs\ntraining:\n  max_iterations: 30000\n"
        "meshing:\n  voxel_size: 0.02\n")
    (tmp_path / "datasets" / "ants.yaml").write_text(
        f"file_path: {tmp_path / 'scene'}\n"
        "training:\n  max_iterations: 100\n")
    over = {"training": {"sh_degree": 0}}
    s = Splatter.from_config_file("ants", tmp_path, over, device="cpu")
    js = JSplatter.from_config_file("ants", tmp_path, over)
    assert s.config == js.config
    for stage in ("_preprocess_config", "_training_config",
                  "_meshing_config"):
        assert getattr(s, stage) == getattr(js, stage), stage


def test_visualization_matches():
    """The host mesh painter and the camera frusta on the same mesh and
    camera as JAX's."""
    from collab_splats_tpu.core.cameras import make_camera as jmake_camera
    from collab_splats_tpu.utils import visualization as jvis
    from collab_splats_tpu_torch.data.synthetic import look_at_c2w
    from collab_splats_tpu_torch.utils import visualization as vis

    rng = np.random.default_rng(13)
    verts = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (200, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    c2w = look_at_c2w(np.array([1.6, 1.2, 1.0]), np.zeros(3))
    args = (70.0, 70.0, 40.0, 30.0, 80, 60, c2w)
    jcam = jmake_camera(*args)
    tcam = camera_from_numpy(np.asarray(jcam.K), c2w, 80, 60, device="cpu")
    np.testing.assert_allclose(vis.render_mesh(verts, faces, colors, tcam),
                               jvis.render_mesh(verts, faces, colors, jcam),
                               atol=1e-6)
    np.testing.assert_allclose(vis.camera_frustum_lines(tcam, 0.2),
                               jvis.camera_frustum_lines(jcam, 0.2),
                               atol=1e-6)


def test_mesher_types(jax_run):
    """``mesh()`` dispatches the level-set mesher (at a small grid) and
    rejects an unknown type, as JAX's does."""
    d, _ = jax_run
    s = port_splatter(d, "port_levelset", max_iterations=3)
    s.preprocess()
    s.train(**s._training_config)
    res = s.mesh(mesher_type="LevelSetExtractor", resolution=24)
    assert len(res["vertices"]) > 0 and (s.mesh_dir / "mesh.ply").exists()
    with pytest.raises(ValidationError, match="mesher_type"):
        s.mesh(overwrite=True, mesher_type="Nope")

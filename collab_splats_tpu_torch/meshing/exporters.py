"""Mesh exporters: render-integrate-extract pipelines over a trained splat.

Counterpart of the JAX package's ``meshing/exporters.py`` (the reference's
exporter suite).  The default ``TSDFFusionExporter`` mirrors
``Open3DTSDFFusion.main()``:

  1. export ``splats.ply`` (means, SH0 colors, smallest-axis normals),
  2. one render per training frame -> TSDF integrate (depth map selected by
     ``depth_name``, default median_depth),
  3. iso-surface extraction + clean/repair,
  4. color / normal / latent-feature transfer to vertices,
  5. optional floor alignment,
  6. write mesh.ply + mesh_features.npz; return {"mesh", "features"}.

Every exporter runs on the device of the parameters it is given: renders,
TSDF updates, the k-NN transfer, the density grid and the Poisson splat and
solve stay there.  Marching, repair, alignment and the PLY writer are host
numpy, as in JAX; a volume or field moves to the host once per export.
``main`` takes an optional ``stage_times`` dict that receives the host
seconds of each stage (``utils/stages.py``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.cameras import Camera, camera_rays
from ..core.projection import covariance3d, min_axis_normal
from ..core.sh import sh0_to_rgb
from ..data.ply import write_ply
from ..models import rade_gs
from ..models.gaussians import GaussianParams
from ..utils.stages import StageTimer
from . import align, repair, transfer
from .marching import marching_tetrahedra, trilinear_sample
from .poisson import poisson_reconstruct
from .tsdf import integrate, volume_from_bounds, voxel_centers


@dataclasses.dataclass(frozen=True)
class TSDFExporterConfig:
    """Field names and defaults are the JAX package's."""

    voxel_size: float = 0.01
    sdf_trunc: float = 0.03
    depth_trunc: float = 1.0
    depth_name: str = "median_depth"    # "median_depth" | "depth"
    alpha_thresh: float = 0.5
    max_dim: int = 384
    clean_repair: bool = True
    min_component_fraction: float = 0.05
    max_hole_edges: int = 64
    align_floor: bool = True
    transfer_k: int = 5


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _render_fn(params, alive, model_config):
    """One camera's output dict (evaluation render, black background)."""
    return lambda cam: rade_gs.get_outputs(
        params, alive, cam, 0, model_config, training=False)[0]


class TSDFFusionExporter:
    """The default mesh exporter (reference Open3DTSDFFusion)."""

    def __init__(
        self,
        params: GaussianParams,
        alive: torch.Tensor,
        model_config: rade_gs.RadeGSConfig,
        config: TSDFExporterConfig = TSDFExporterConfig(),
    ):
        self.params = params
        self.alive = alive.to(torch.bool)
        self.model_config = model_config
        self.config = config
        # The last export's TSDF config and volume, kept for callers that
        # inspect them.
        self.tsdf_config = None
        self.volume = None

    def splat_normals(self) -> torch.Tensor:
        """The alive Gaussians' smallest-axis unit normals [N, 3]."""
        return min_axis_normal(self.params["quats"],
                               torch.exp(self.params["scales"]))[self.alive]

    @torch.no_grad()
    def export_splats_ply(self, path: str | Path) -> None:
        """splats.ply: means + SH0 colors + smallest-axis normals."""
        alive = self.alive
        means = _numpy(self.params["means"][alive])
        colors = np.clip(_numpy(sh0_to_rgb(self.params["features_dc"])[alive]),
                         0, 1)
        write_ply(str(path), means, colors=colors,
                  normals=_numpy(self.splat_normals()))

    @torch.no_grad()
    def main(
        self,
        cameras: Sequence[Camera],
        output_dir: Optional[str | Path] = None,
        stage_times: Optional[dict] = None,
    ) -> Dict[str, np.ndarray]:
        cfg = self.config
        mcfg = self.model_config
        dev = self.params["means"].device
        timer = StageTimer(stage_times, dev)
        pts = self.params["means"][self.alive]
        lo = _numpy(pts.min(0).values) - 0.1
        hi = _numpy(pts.max(0).values) + 0.1
        latent = mcfg.latent_dim
        tcfg, volume = volume_from_bounds(
            lo, hi, cfg.voxel_size, cfg.sdf_trunc, cfg.depth_trunc,
            feature_dim=latent, max_dim=cfg.max_dim, device=dev,
        )
        centers = voxel_centers(tcfg, dev)

        render = _render_fn(self.params, self.alive, mcfg)
        for cam in cameras:
            with timer("render"):
                out = render(cam)
            with timer("integrate"):
                volume = integrate(
                    volume, out[cfg.depth_name], out["rgb"], cam, tcfg,
                    features=out.get("features") if latent else None,
                    alpha=out["accumulation"], alpha_thresh=cfg.alpha_thresh,
                    points=centers)
            del out
        del centers
        self.tsdf_config, self.volume = tcfg, volume

        with timer("to host"):
            tsdf = _numpy(volume.tsdf)
            weight = _numpy(volume.weight)
            color = _numpy(volume.color)
        with timer("marching"):
            verts_vox, faces = marching_tetrahedra(tsdf, mask=weight > 0)
        if len(faces) and cfg.clean_repair:
            with timer("clean repair"):
                verts_vox, faces = repair.clean_repair_mesh(
                    verts_vox, faces, cfg.min_component_fraction,
                    cfg.max_hole_edges,
                )

        verts = verts_vox * tcfg.voxel_size + np.asarray(tcfg.origin)
        colors = trilinear_sample(color, verts_vox)
        with timer("transfer"):
            # Normals and latents go to the same vertices from the same
            # Gaussians: one neighbour search serves both, and each column
            # of the weighted sum is reduced on its own, so the values equal
            # two separate transfers' (JAX calls it twice).
            values = self.splat_normals()
            if latent:
                values = torch.cat(
                    [values, self.params["distill_features"][self.alive]], -1)
            if len(verts):
                idx, d2 = transfer.knn_neighbours(
                    torch.as_tensor(verts, dtype=torch.float32, device=dev),
                    pts, k=cfg.transfer_k)
                moved = _numpy(transfer.apply_weights(
                    idx, transfer.knn_weights(d2), values))
            else:
                moved = np.zeros((0, values.shape[1]), np.float32)
        vert_normals = moved[:, :3]
        vert_features = moved[:, 3:] if latent else None

        floor_T = np.eye(4)
        if cfg.align_floor and len(verts) > 100:
            with timer("floor alignment"):
                floor_T = align.floor_alignment_transform(verts)
                verts = align.apply_transform(verts, floor_T)
                vert_normals = vert_normals @ floor_T[:3, :3].T

        result = {
            "vertices": verts.astype(np.float32),
            "faces": faces,
            "colors": np.clip(colors, 0, 1).astype(np.float32),
            "normals": vert_normals.astype(np.float32),
            "floor_transform": floor_T,
        }
        if vert_features is not None:
            result["features"] = vert_features.astype(np.float32)

        if output_dir is not None:
            with timer("write ply"):
                output_dir = Path(output_dir)
                output_dir.mkdir(parents=True, exist_ok=True)
                self.export_splats_ply(output_dir / "splats.ply")
                write_ply(
                    str(output_dir / "mesh.ply"), result["vertices"],
                    colors=result["colors"], normals=result["normals"],
                    faces=result["faces"],
                )
                np.savez(
                    output_dir / "mesh_features.npz",
                    features=result.get("features", np.zeros((0, 0))),
                    floor_transform=floor_T,
                )
        return result


# Entries of one [voxel chunk, Gaussian chunk] float32 term of the density
# grid: 256 MiB on the card; 4 MiB, about a core's cache, on the CPU.
_MAX_PAIRS = {"cuda": 1 << 26, "cpu": 1 << 20}


@torch.no_grad()
def gaussian_density_grid(
    params: GaussianParams,
    alive,
    lo: np.ndarray,
    hi: np.ndarray,
    resolution: int = 128,
    opacity_weighted: bool = True,
    chunk: int = 4096,
):
    """Evaluate the 3D Gaussian-mixture density on a dense grid.

    The field behind the reference's SuGaR ``LevelSetExtractor`` and
    ``MarchingCubesMesh``: the sum of (optionally opacity-weighted)
    Gaussian densities, on the parameters' device.  JAX fuses the
    [V_chunk, N, 3] differences into one einsum; eager PyTorch would
    materialise them, so voxels go in chunks of ``chunk`` and Gaussians in
    chunks that keep each [V_chunk, N_chunk] term bounded.  The quadratic
    form is built from the six unique precision entries, and the Gaussian
    chunks' sums are added into the voxel chunk in a fixed order, with no
    atomics.

    Returns (density [R, R, R], voxel_size [3], origin [3]) as numpy.
    """
    alive = torch.as_tensor(alive).to(device=params["means"].device,
                                      dtype=torch.bool)
    means = params["means"][alive]
    scales = torch.exp(params["scales"][alive])
    quats = params["quats"][alive]
    opac = torch.sigmoid(params["opacities"][alive][:, 0])
    if not opacity_weighted:
        opac = torch.ones_like(opac)
    dev = means.device

    cov = covariance3d(quats, scales)
    prec = torch.linalg.inv(cov + 1e-9 * torch.eye(3, device=dev)[None])
    p00, p11, p22 = prec[:, 0, 0], prec[:, 1, 1], prec[:, 2, 2]
    p01, p02, p12 = prec[:, 0, 1], prec[:, 0, 2], prec[:, 1, 2]

    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    voxel = (hi - lo) / (resolution - 1)
    axes = [torch.as_tensor((lo[i] + voxel[i] * np.arange(resolution))
                            .astype(np.float32), device=dev)
            for i in range(3)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       dim=-1).reshape(-1, 3)

    n = means.shape[0]
    nc = max(1, min(n, _MAX_PAIRS.get(dev.type, 1 << 20) // max(chunk, 1)))
    dens = torch.zeros(grid.shape[0], device=dev)
    for start in range(0, grid.shape[0], chunk):
        pts = grid[start:start + chunk]
        acc = dens[start:start + chunk]
        for g in range(0, n, nc):
            sl = slice(g, g + nc)
            dx = pts[:, 0:1] - means[None, sl, 0]
            dy = pts[:, 1:2] - means[None, sl, 1]
            dz = pts[:, 2:3] - means[None, sl, 2]
            q = (p00[sl] * dx * dx + p11[sl] * dy * dy + p22[sl] * dz * dz
                 + 2.0 * (p01[sl] * dx * dy + p02[sl] * dx * dz
                          + p12[sl] * dy * dz))
            acc += torch.sum(opac[None, sl] * torch.exp(-0.5 * q), dim=1)
    dens = _numpy(dens).reshape(resolution, resolution, resolution)
    return dens, voxel.astype(np.float32), lo.astype(np.float32)


class LevelSetExtractor:
    """SuGaR-style level-set mesh: extract the iso-surface of the
    opacity-weighted Gaussian density field."""

    def __init__(self, params, alive, model_config,
                 level: float = 0.5, resolution: int = 128):
        self.params = params
        self.alive = alive.to(torch.bool)
        self.model_config = model_config
        self.level = level
        self.resolution = resolution

    @torch.no_grad()
    def main(self, output_dir=None, stage_times: Optional[dict] = None
             ) -> Dict[str, np.ndarray]:
        timer = StageTimer(stage_times, self.params["means"].device)
        pts = self.params["means"][self.alive]
        lo = _numpy(pts.min(0).values) - 0.1
        hi = _numpy(pts.max(0).values) + 0.1
        with timer("density grid"):
            dens, voxel, origin = gaussian_density_grid(
                self.params, self.alive, lo, hi, self.resolution
            )
        with timer("marching"):
            # Marching expects inside = negative.
            verts_vox, faces = marching_tetrahedra(-(dens - self.level))
        verts = verts_vox * voxel[None, :] + origin[None, :]
        with timer("transfer"):
            colors = _numpy(transfer.knn_weighted_transfer(
                torch.as_tensor(verts, dtype=torch.float32,
                                device=pts.device),
                pts,
                torch.clamp(sh0_to_rgb(self.params["features_dc"])
                            [self.alive], 0, 1),
                k=3,
            )) if len(verts) else np.zeros((0, 3), np.float32)
        result = {"vertices": verts.astype(np.float32), "faces": faces,
                  "colors": colors}
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            write_ply(str(output_dir / "mesh.ply"), result["vertices"],
                      colors=result["colors"], faces=result["faces"])
        return result


class MarchingCubesMeshExporter(LevelSetExtractor):
    """Density-threshold marching mesh (reference MarchingCubesMesh) -- the
    same field at a configurable iso level."""


class DepthAndNormalMapsPoissonExporter:
    """Back-project rendered depth + normal maps into an oriented point
    cloud and run Poisson surface reconstruction over it (reference
    DepthAndNormalMapsPoisson; here the spectral grid solver in
    meshing/poisson.py).  The back-projection runs on the parameters'
    device; the cloud moves to the host once, for the solver's bounds."""

    def __init__(self, params, alive, model_config,
                 depth_name: str = "median_depth", alpha_thresh: float = 0.5,
                 stride: int = 2, grid_res: int = 256, screen: float = 0.0):
        self.params = params
        self.alive = alive.to(torch.bool)
        self.model_config = model_config
        self.depth_name = depth_name
        self.alpha_thresh = alpha_thresh
        self.stride = stride
        self.grid_res = grid_res
        self.screen = screen

    @torch.no_grad()
    def main(self, cameras: Sequence[Camera], output_dir=None,
             stage_times: Optional[dict] = None):
        dev = self.params["means"].device
        timer = StageTimer(stage_times, dev)
        all_pts, all_normals, all_colors = [], [], []
        render = _render_fn(self.params, self.alive, self.model_config)
        s = self.stride
        for cam in cameras:
            with timer("render"):
                out = render(cam)
            with timer("back-project"):
                mask = out["accumulation"][::s, ::s] > self.alpha_thresh
                depth = out[self.depth_name][..., None]
                p_cam = (camera_rays(cam) * depth)[::s, ::s][mask]
                n_cam = out["normal_cam"][::s, ::s][mask]
                # Camera -> world (COLMAP camera space).
                w2c = cam.viewmat()
                R = w2c[:3, :3]
                all_pts.append((p_cam - w2c[:3, 3]) @ R)
                all_normals.append(n_cam @ R)
                all_colors.append(out["rgb"][::s, ::s][mask])
        with timer("to host"):
            pts = _numpy(torch.cat(all_pts)) if all_pts \
                else np.zeros((0, 3), np.float32)
            normals = _numpy(torch.cat(all_normals)) if all_normals \
                else np.zeros((0, 3), np.float32)
            colors = _numpy(torch.cat(all_colors)) if all_colors \
                else np.zeros((0, 3), np.float32)
        nn = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.clip(nn, 1e-8, None)

        verts, faces, vcols = poisson_reconstruct(
            pts, normals, grid_res=self.grid_res, screen=self.screen,
            colors=np.clip(colors, 0, 1), device=dev,
            stage_times=stage_times,
        )
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            write_ply(str(output_dir / "oriented_points.ply"),
                      pts.astype(np.float32),
                      colors=np.clip(colors, 0, 1).astype(np.float32),
                      normals=normals.astype(np.float32))
            if len(verts):
                write_ply(str(output_dir / "mesh.ply"), verts,
                          colors=vcols, faces=faces)
        return {"points": pts, "normals": normals, "colors": colors,
                "vertices": verts, "faces": faces,
                "vertex_colors": vcols}


class GaussiansToPoissonExporter:
    """Point-cloud route (reference GaussiansToPoisson): splat centers with
    min-axis normals + colors feed the spectral Poisson solver
    (meshing/poisson.py)."""

    def __init__(self, params, alive, model_config, grid_res: int = 256,
                 screen: float = 0.0):
        self.params = params
        self.alive = alive.to(torch.bool)
        self.model_config = model_config
        self.grid_res = grid_res
        self.screen = screen

    def oriented_points(self, opacity_thresh: float = 0.1):
        """(means, colors, normals) of the alive Gaussians above the
        opacity threshold, as numpy."""
        with torch.no_grad():
            opac = torch.sigmoid(self.params["opacities"][:, 0])
            keep = self.alive & (opac > opacity_thresh)
            means = _numpy(self.params["means"][keep])
            colors = np.clip(
                _numpy(sh0_to_rgb(self.params["features_dc"])[keep]), 0, 1)
            normals = _numpy(min_axis_normal(
                self.params["quats"], torch.exp(self.params["scales"]))[keep])
        return means, colors, normals

    def main(self, output_dir: str | Path, opacity_thresh: float = 0.1,
             stage_times: Optional[dict] = None):
        means, colors, normals = self.oriented_points(opacity_thresh)
        verts, faces, vcols = poisson_reconstruct(
            means, normals, grid_res=self.grid_res, screen=self.screen,
            colors=colors, device=self.params["means"].device,
            stage_times=stage_times,
        )
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        write_ply(str(output_dir / "oriented_points.ply"), means,
                  colors=colors, normals=normals)
        if len(verts):
            write_ply(str(output_dir / "mesh.ply"), verts,
                      colors=vcols, faces=faces)
        return {"points": means, "colors": colors, "normals": normals,
                "vertices": verts, "faces": faces, "vertex_colors": vcols}

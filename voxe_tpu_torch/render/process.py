"""Point processing: voxel-grid query + SH shading at sampled ray points
(counterpart of voxe_tpu/render/process.py: the SH grid, its attention
channel, and the feature-voxel grid's MLP decode)."""
from __future__ import annotations

import math

import torch

from voxe_tpu_torch.grid.feature_voxels import FeatureVoxelGrid, feature_grid_query
from voxe_tpu_torch.grid.voxels import VoxelGrid, grid_query, grid_query_attn, test_inside_volume
from voxe_tpu_torch.render.rays import Rays
from voxe_tpu_torch.render.sample import SampledPointsOnRays
from voxe_tpu_torch.render.sh import evaluate_spherical_harmonics
from voxe_tpu_torch.utils.constants import INFINITY, NUM_COLOUR_CHANNELS


def _shade_and_mask(
    voxel_grid: VoxelGrid,
    flat_points: torch.Tensor,  # [N*S, 3]
    interpolated: torch.Tensor,  # [N*S, C*K + 1]
    rays: Rays,
    num_samples: int,
    num_channels: int,
    render_diffuse: bool,
) -> torch.Tensor:
    """[N, S, C+1]: SH radiance with view dirs broadcast over samples; outside
    the AABB radiance is -INFINITY (sigmoid 0) and density 0."""
    sh_coeffs, raw_densities = interpolated[..., :-1], interpolated[..., -1:]
    dirs = rays.directions.reshape(-1, 3)
    viewdirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    sh_coeffs = sh_coeffs.reshape(-1, num_samples, num_channels, sh_coeffs.shape[-1] // num_channels)
    if render_diffuse:
        sh_coeffs, sh_degree = sh_coeffs[..., :1], 0
    else:
        sh_degree = int(math.isqrt(sh_coeffs.shape[-1])) - 1
    raw_radiance = evaluate_spherical_harmonics(sh_degree, sh_coeffs, viewdirs[:, None, :])
    inside = test_inside_volume(voxel_grid.aabb, flat_points).reshape(-1, num_samples, 1)
    raw_radiance = torch.where(inside, raw_radiance, torch.full((), -INFINITY, device=inside.device))
    raw_densities = torch.where(
        inside, raw_densities.reshape(-1, num_samples, 1), torch.zeros((), device=inside.device)
    )
    return torch.cat([raw_radiance, raw_densities], dim=-1)


def process_points_with_sh_voxel_grid(
    sampled_points: SampledPointsOnRays,
    rays: Rays,
    voxel_grid: VoxelGrid,
    render_diffuse: bool = False,
) -> torch.Tensor:
    """[N, S, 3+1]: per-sample (rgb radiance, raw density)."""
    num_samples = sampled_points.points.shape[1]
    flat_points = sampled_points.points.reshape(-1, 3)
    interpolated = grid_query(voxel_grid, flat_points)
    return _shade_and_mask(
        voxel_grid, flat_points, interpolated, rays, num_samples, NUM_COLOUR_CHANNELS, render_diffuse
    )


def process_points_with_feature_voxel_grid(
    sampled_points: SampledPointsOnRays,
    rays: Rays,
    voxel_grid: FeatureVoxelGrid,
    render_diffuse: bool = False,
) -> torch.Tensor:
    """[N, S, 3+1]: per-sample (raw rgb from the MLP head, raw density) for
    the feature-voxel grid; outside the AABB radiance is -INFINITY (sigmoid
    0) and density 0, as on the SH path. `render_diffuse` is accepted for
    the same interface: the MLP's radiance is view-independent already."""
    del render_diffuse
    num_samples = sampled_points.points.shape[1]
    flat_points = sampled_points.points.reshape(-1, 3)
    decoded = feature_grid_query(voxel_grid, flat_points)  # [N*S, 4]
    inside = test_inside_volume(voxel_grid.aabb, flat_points).reshape(-1, num_samples, 1)
    raw_radiance = torch.where(
        inside, decoded[..., :-1].reshape(-1, num_samples, NUM_COLOUR_CHANNELS),
        torch.full((), -INFINITY, device=inside.device),
    )
    raw_densities = torch.where(
        inside, decoded[..., -1:].reshape(-1, num_samples, 1), torch.zeros((), device=inside.device)
    )
    return torch.cat([raw_radiance, raw_densities], dim=-1)


def process_points_with_sh_voxel_grid_attn(
    sampled_points: SampledPointsOnRays,
    rays: Rays,
    voxel_grid: VoxelGrid,
    render_diffuse: bool = False,
    use_orig_densities: bool = False,
) -> torch.Tensor:
    """[N, S, 1+1]: per-sample (attention logit, raw density), the attention
    shaded as one SH channel."""
    num_samples = sampled_points.points.shape[1]
    flat_points = sampled_points.points.reshape(-1, 3)
    interpolated = grid_query_attn(voxel_grid, flat_points, use_orig_densities=use_orig_densities)
    return _shade_and_mask(voxel_grid, flat_points, interpolated, rays, num_samples, 1, render_diffuse)

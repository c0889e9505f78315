"""Render configuration and the exact SH-voxel-grid render procedure
(counterpart of voxe_tpu/render/interface.py: sampler -> point processor ->
accumulator), for the colour, for the attention channel, and for the
feature-voxel grid."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from voxe_tpu_torch.grid.feature_voxels import FeatureVoxelGrid
from voxe_tpu_torch.grid.voxels import VoxelGrid
from voxe_tpu_torch.render.accumulate import RenderOut, accumulate_radiance_density_on_rays
from voxe_tpu_torch.render.process import (
    process_points_with_feature_voxel_grid,
    process_points_with_sh_voxel_grid,
    process_points_with_sh_voxel_grid_attn,
)
from voxe_tpu_torch.render.rays import Rays, flatten_rays
from voxe_tpu_torch.render.sample import (
    sample_aabb_bound_uniform_points_on_rays,
    sample_uniform_points_on_rays,
)
from voxe_tpu_torch.utils.camera import CameraBounds


@dataclasses.dataclass(frozen=True)
class SHVoxGridRenderConfig:
    """Static render configuration (same fields and defaults as voxe_tpu's)."""

    num_samples_per_ray: int
    camera_bounds: CameraBounds
    perturb_sampled_points: bool = True
    optimized_sampling: bool = False
    linear_disparity_sampling: bool = False

    stochastic_density_noise_std: float = 0.0
    white_bkgd: bool = False

    render_diffuse: bool = False
    render_num_samples_per_ray: int = 1024
    parallel_rays_chunk_size: int = 32768

    # compositing through the hand-written CUDA kernel (ops/composite.py)
    use_fused_kernel: bool = False

    def replace(self, **kwargs) -> "SHVoxGridRenderConfig":
        return dataclasses.replace(self, **kwargs)


def _sample(
    voxel_grid: VoxelGrid,
    rays: Rays,
    config: SHVoxGridRenderConfig,
    generator: Optional[torch.Generator],
    t_rand: Optional[torch.Tensor] = None,
):
    """Sample points on rays: jittered when the config asks for it and a
    generator (or an explicit `t_rand` draw) is given."""
    perturb = config.perturb_sampled_points and (generator is not None or t_rand is not None)
    if config.optimized_sampling:
        return sample_aabb_bound_uniform_points_on_rays(
            rays, bounds=config.camera_bounds, num_samples=config.num_samples_per_ray,
            aabb=voxel_grid.aabb, perturb=perturb, generator=generator, t_rand=t_rand,
        )
    return sample_uniform_points_on_rays(
        rays, bounds=config.camera_bounds, num_samples=config.num_samples_per_ray,
        perturb=perturb, linear_disparity_sampling=config.linear_disparity_sampling,
        generator=generator, t_rand=t_rand,
    )


def render_sh_voxel_grid(
    voxel_grid: VoxelGrid,
    rays: Rays,
    config: SHVoxGridRenderConfig,
    generator: Optional[torch.Generator] = None,
    extra_debug_info: bool = False,
    t_rand: Optional[torch.Tensor] = None,
    density_noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Render flat rays against an SH voxel grid. With no generator (and no
    `t_rand` / `density_noise`) there is no jitter and no density noise: the
    deterministic eval mode."""
    rays = flatten_rays(rays)
    sampled = _sample(voxel_grid, rays, config, generator, t_rand)
    if config.use_fused_kernel:
        from voxe_tpu_torch.ops.composite import fused_shade_composite

        return fused_shade_composite(voxel_grid, sampled, rays, config, generator, extra_debug_info, density_noise)
    processed = process_points_with_sh_voxel_grid(
        sampled, rays, voxel_grid, render_diffuse=config.render_diffuse
    )
    return accumulate_radiance_density_on_rays(
        processed,
        sampled.depths,
        rays,
        stochastic_density_noise_std=config.stochastic_density_noise_std,
        white_bkgd=config.white_bkgd,
        background_value=1.0,
        extra_debug_info=extra_debug_info,
        generator=generator,
        density_noise=density_noise,
    )


def draw_ray_randomness(config: SHVoxGridRenderConfig, num_rays: int, generator: Optional[torch.Generator],
                        density_noise: bool = True):
    """(t_rand, density_noise), each [R, S] or None: what an exact render of
    `num_rays` rays draws from `generator`, in its order (the noise only
    with `density_noise`, for a render that adds it). A sharded step draws
    them for the whole batch and passes its rays' rows, so every rank
    draws what the unsharded step draws."""
    if generator is None:
        return None, None
    shape = (num_rays, config.num_samples_per_ray)
    t_rand = torch.rand(shape, generator=generator, device=generator.device) if (
        config.perturb_sampled_points) else None
    noise = torch.randn(shape, generator=generator, device=generator.device) if (
        density_noise and config.stochastic_density_noise_std > 0.0) else None
    return t_rand, noise


def render_feature_voxel_grid(
    voxel_grid: FeatureVoxelGrid,
    rays: Rays,
    config: SHVoxGridRenderConfig,
    generator: Optional[torch.Generator] = None,
    extra_debug_info: bool = False,
    t_rand: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Render flat rays against the feature-voxel grid (grid + MLP head),
    through the plain compositor as the JAX package does
    (`config.use_fused_kernel` is not read here). Generator and `t_rand`
    as for `render_sh_voxel_grid`."""
    rays = flatten_rays(rays)
    sampled = _sample(voxel_grid, rays, config, generator, t_rand)
    processed = process_points_with_feature_voxel_grid(
        sampled, rays, voxel_grid, render_diffuse=config.render_diffuse
    )
    return accumulate_radiance_density_on_rays(
        processed,
        sampled.depths,
        rays,
        stochastic_density_noise_std=config.stochastic_density_noise_std,
        white_bkgd=config.white_bkgd,
        background_value=1.0,
        extra_debug_info=extra_debug_info,
        generator=generator,
    )


def render_sh_voxel_grid_attn(
    voxel_grid: VoxelGrid,
    rays: Rays,
    config: SHVoxGridRenderConfig,
    generator: Optional[torch.Generator] = None,
    use_orig_densities: bool = False,
    extra_debug_info: bool = False,
    t_rand: Optional[torch.Tensor] = None,
    density_noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Render the grid's attention channel, composited on black. As in the
    JAX package, `config.use_fused_kernel` applies to the colour render only:
    this path always takes the plain compositor. `t_rand` / `density_noise`
    replace the draws, as for `render_sh_voxel_grid`."""
    rays = flatten_rays(rays)
    sampled = _sample(voxel_grid, rays, config, generator, t_rand)
    processed = process_points_with_sh_voxel_grid_attn(
        sampled, rays, voxel_grid, render_diffuse=config.render_diffuse, use_orig_densities=use_orig_densities
    )
    return accumulate_radiance_density_on_rays(
        processed,
        sampled.depths,
        rays,
        stochastic_density_noise_std=config.stochastic_density_noise_std,
        white_bkgd=config.white_bkgd,
        background_value=0.0,
        extra_debug_info=extra_debug_info,
        generator=generator,
        density_noise=density_noise,
    )

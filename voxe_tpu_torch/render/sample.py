"""Point sampling along rays: uniform / stratified, linear-disparity and
ray-AABB-bounded (counterpart of voxe_tpu/render/sample.py).

The stratified jitter is drawn from an explicit `torch.Generator`; a caller
may instead hand in the draw itself as `t_rand` ([N, S] in [0, 1)), which is
how tests feed both packages the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from voxe_tpu_torch.grid.voxels import AxisAlignedBoundingBox, _aabb_tensors
from voxe_tpu_torch.render.rays import Rays
from voxe_tpu_torch.utils.camera import CameraBounds
from voxe_tpu_torch.utils.constants import ZERO_PLUS


class SampledPointsOnRays(NamedTuple):
    points: torch.Tensor  # [N, S, 3]
    depths: torch.Tensor  # [N, S]


def sample_uniform_points_on_rays(
    rays: Rays,
    bounds: Union[CameraBounds, torch.Tensor],
    num_samples: int,
    perturb: bool = True,
    linear_disparity_sampling: bool = False,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
) -> SampledPointsOnRays:
    """Uniform (optionally jittered or inverse-depth spaced) depths on rays;
    `bounds` is a scalar CameraBounds or a per-ray [N, 2] tensor."""
    rays_o = rays.origins.reshape(-1, 3)
    rays_d = rays.directions.reshape(-1, 3)
    num_rays, dev = rays_o.shape[0], rays_o.device
    if isinstance(bounds, CameraBounds):
        near = torch.full((num_rays, 1), bounds.near, dtype=rays_o.dtype, device=dev)
        far = torch.full((num_rays, 1), bounds.far, dtype=rays_o.dtype, device=dev)
    else:
        near, far = bounds[:, :1], bounds[:, 1:]

    t_vals = torch.linspace(0.0, 1.0, num_samples, dtype=rays_o.dtype, device=dev)[None, :]
    if linear_disparity_sampling:
        z_vals = 1.0 / (1.0 / (near + ZERO_PLUS) * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals

    if perturb:
        if t_rand is None:
            if generator is None:
                raise ValueError("perturbed sampling needs a torch.Generator or an explicit t_rand")
            t_rand = torch.rand(z_vals.shape, generator=generator, device=generator.device).to(dev)
        mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mid, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mid], dim=-1)
        z_vals = lower + (upper - lower) * t_rand

    points = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return SampledPointsOnRays(points, z_vals)


def ray_aabb_intersection(
    rays: Rays, bounds: CameraBounds, aabb: AxisAlignedBoundingBox
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test -> per-ray [N, 2] (near, far) and an [N, 1] hit mask. Rays
    that miss take the scene bounds; hits behind the camera clip to 0; the
    interval is nudged outward by 1e-3 of its span, as in the JAX package."""
    origins = rays.origins.reshape(-1, 3)
    directions = rays.directions.reshape(-1, 3)
    mins, maxs = _aabb_tensors(aabb, origins)
    inv_dir = 1.0 / (directions + ZERO_PLUS)
    t0 = (mins[None, :] - origins) * inv_dir
    t1 = (maxs[None, :] - origins) * inv_dir
    t_near = torch.minimum(t0, t1).amax(dim=-1, keepdim=True)
    t_far = torch.maximum(t0, t1).amin(dim=-1, keepdim=True)
    intersecting = t_near <= t_far
    span = t_far - t_near
    t_near = t_near - 1e-3 * span
    t_far = t_far + 1e-3 * span
    orig = torch.tensor([bounds.near, bounds.far], dtype=origins.dtype, device=origins.device)
    ray_bounds = torch.where(intersecting, torch.cat([t_near, t_far], dim=-1), orig[None, :])
    return ray_bounds.clamp(min=0.0), intersecting


def sample_aabb_bound_uniform_points_on_rays(
    rays: Rays,
    bounds: CameraBounds,
    num_samples: int,
    aabb: AxisAlignedBoundingBox,
    perturb: bool = True,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
) -> SampledPointsOnRays:
    """Samples confined to each ray's AABB intersection."""
    ray_bounds, _ = ray_aabb_intersection(rays, bounds, aabb)
    return sample_uniform_points_on_rays(
        rays, bounds=ray_bounds, num_samples=num_samples, perturb=perturb,
        generator=generator, t_rand=t_rand,
    )

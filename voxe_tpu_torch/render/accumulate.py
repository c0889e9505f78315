"""Alpha compositing (Beer-Lambert emission-absorption) along rays
(counterpart of voxe_tpu/render/accumulate.py)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from voxe_tpu_torch.render.rays import Rays
from voxe_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    EXTRA_DISPARITY,
    EXTRA_POINT_DENSITIES,
    EXTRA_POINT_DEPTHS,
    EXTRA_POINT_OCCUPANCIES,
    EXTRA_POINT_WEIGHTS,
    EXTRA_SAMPLE_INTERVALS,
    INFINITY,
    ZERO_PLUS,
)


class RenderOut(NamedTuple):
    colour: torch.Tensor  # [N, C]
    depth: torch.Tensor  # [N, 1]
    extra: Dict[str, torch.Tensor]


def safe_disparity(depth_render: torch.Tensor, acc_render: torch.Tensor) -> torch.Tensor:
    """1 / (depth/acc), clamping the denominator so rays with acc == 0 give
    a finite value instead of 0/0."""
    return 1.0 / torch.clamp(
        depth_render / torch.clamp(acc_render, min=ZERO_PLUS), min=ZERO_PLUS
    )


def density2occupancy_pb(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Physically based occupancy 1 - exp(-sigma * delta)."""
    return 1.0 - torch.exp(-(densities * deltas))


def accumulate_radiance_density_on_rays(
    processed_points,  # [N, S, C+1], or a (radiance [N, S, C], density [N, S]) tuple
    depths: torch.Tensor,  # [N, S]
    rays: Rays,
    stochastic_density_noise_std: float = 0.0,
    white_bkgd: bool = True,
    background_value: float = 1.0,
    extra_debug_info: bool = False,
    generator: Optional[torch.Generator] = None,
    final_delta: str = "inf",
    density_noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Composite per-sample (radiance, density) into per-ray colour and depth.

    `final_delta` "inf" gives the last sample an INFINITY interval (exact
    renderer); "slab" repeats the last spacing (shear-warp: the volume ends at
    its far face). The compositing kernel's routes are
    `ops.composite.fused_shade_composite` (the exact renderer) and
    `ops.composite.composite_render` (the shear-warp tail). A tuple input
    keeps the radiance in its own (e.g. bf16) dtype while the weights math
    stays f32. The density noise is `density_noise` ([N, S] standard
    normals) when given, else a draw from `generator`."""
    if isinstance(processed_points, tuple):
        raw_radiance, raw_density = processed_points
    else:
        raw_radiance, raw_density = processed_points[..., :-1], processed_points[..., -1]
    dir_norms = torch.linalg.norm(rays.directions.reshape(-1, 3), dim=-1)

    if stochastic_density_noise_std > 0.0:
        noise = density_noise
        if noise is None:
            if generator is None:
                raise ValueError("density noise needs a torch.Generator or density_noise")
            noise = torch.randn(raw_density.shape, generator=generator, device=generator.device)
        raw_density = raw_density + noise.to(raw_density.device) * stochastic_density_noise_std

    deltas = depths[..., 1:] - depths[..., :-1]
    if final_delta == "slab":
        last = deltas[..., -1:]
    else:
        last = torch.full_like(deltas[..., :1], INFINITY)
    deltas = torch.cat([deltas, last], dim=-1) * dir_norms[..., None]
    alpha = None
    if extra_debug_info:
        alpha = density2occupancy_pb(raw_density, deltas)
        ones = torch.ones_like(alpha[..., :1])
        transmittance = torch.cumprod(torch.cat([ones, 1.0 - alpha], dim=-1), dim=-1)[..., :-1]
        weights = alpha * transmittance
        acc_render = weights.sum(dim=-1, keepdim=True)
    else:
        # same math in fewer passes: prod_{j<i}(1 - alpha_j) =
        # exp(-sum_{j<i} sigma_j d_j), so w_i = T_i - T_{i+1}
        optical = torch.cumsum(raw_density * deltas, dim=-1)
        t_incl = torch.exp(-optical)
        t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], dim=-1)
        weights = t_excl - t_incl
        acc_render = 1.0 - t_incl[..., -1:]

    colour = torch.sigmoid(raw_radiance)
    # weights in the radiance dtype, products and sum in f32 (bf16 x bf16 is
    # exact in f32), as the JAX einsum with preferred_element_type does
    colour_render = torch.einsum("...s,...sc->...c", weights.to(colour.dtype).float(), colour.float())
    if white_bkgd:
        colour_render = colour_render + (1.0 - acc_render) * background_value

    depth_render = torch.sum(depths * weights, dim=-1, keepdim=True)
    extra = {
        EXTRA_DISPARITY: safe_disparity(depth_render, acc_render),
        EXTRA_ACCUMULATED_WEIGHTS: acc_render,
    }
    if extra_debug_info:
        extra.update({
            EXTRA_POINT_DENSITIES: raw_density,
            EXTRA_POINT_OCCUPANCIES: alpha,
            EXTRA_POINT_WEIGHTS: weights,
            EXTRA_POINT_DEPTHS: depths,
            EXTRA_SAMPLE_INTERVALS: deltas,
        })
    return RenderOut(colour=colour_render, depth=depth_render, extra=extra)

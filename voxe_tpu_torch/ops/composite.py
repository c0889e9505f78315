"""Fused alpha compositing: the hand-written Hopper kernel and its plain
PyTorch version (counterpart of voxe_tpu/ops/composite.py).

Per ray: deltas from the next-depth difference (the last one INFINITY),
scaled by the ray direction's norm; alpha = 1 - exp(-sigma * delta); the
exclusive cumulative transmittance; weights = alpha * T; acc = sum(weights).
The CUDA source is `voxe_tpu_torch/csrc/composite_fwd.cu` (it replaces the
Pallas kernel `_composite_pallas` / `_composite_kernel`); it is built with
nvcc for sm_90a at first use and loaded with ctypes.

`composite_weights` is a `torch.autograd.Function`: its forward runs the
kernel on CUDA tensors and the plain version on CPU tensors; a CUDA tensor
the kernel cannot take (dtype, layout, device) raises — there is no
fallback. Its backward re-differentiates the plain version, as the JAX
package's custom VJP does, so the backward launches no kernel. `LAUNCHES`
counts kernel launches and nothing else; `LAUNCHED_SHAPES` holds the [N, S]
of every launch since import. Both are program counters
(`voxe_tpu_torch/utils/tracing.py::count`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from voxe_tpu_torch.ops.cuda_build import CudaLibrary
from voxe_tpu_torch.utils import tracing
from voxe_tpu_torch.utils.constants import INFINITY

_LIB = CudaLibrary(
    "composite_fwd.cu", "voxe_composite_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)
LAUNCHES = 0  # kernel launches since import
LAUNCHED_SHAPES = set()  # (N, S) of every launch since import


def build(verbose: bool = False):
    """Compile the kernel (once per source content) and return the library
    path. `verbose` prints ptxas' report when a build happens."""
    return _LIB.build(verbose)


def composite_weights_reference(
    raw_density: torch.Tensor,  # [N, S]
    depths: torch.Tensor,  # [N, S]
    dir_norms: torch.Tensor,  # [N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (weights [N, S], acc [N])."""
    deltas = torch.cat(
        [depths[..., 1:] - depths[..., :-1], torch.full_like(depths[..., :1], INFINITY)], dim=-1
    )
    deltas = deltas * dir_norms[..., None]
    alpha = 1.0 - torch.exp(-(raw_density * deltas))
    ones = torch.ones_like(alpha[..., :1])
    transmittance = torch.cumprod(torch.cat([ones, 1.0 - alpha], dim=-1), dim=-1)[..., :-1]
    weights = alpha * transmittance
    return weights, weights.sum(dim=-1)


def composite_weights_kernel(
    raw_density: torch.Tensor, depths: torch.Tensor, dir_norms: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: f32, contiguous [N, S], [N, S], [N] on one card."""
    if raw_density.dim() != 2 or depths.shape != raw_density.shape:
        raise ValueError(
            f"composite kernel: sigma and depths must be one [N, S] shape, got "
            f"{tuple(raw_density.shape)} and {tuple(depths.shape)}"
        )
    N, S = raw_density.shape
    if dir_norms.shape != (N,):
        raise ValueError(f"composite kernel: dir_norms must be [{N}], got {tuple(dir_norms.shape)}")
    if N == 0 or S == 0:
        raise ValueError("composite kernel: empty input")
    for name, x in (("sigma", raw_density), ("depths", depths), ("dir_norms", dir_norms)):
        if x.device.type != "cuda" or x.device != raw_density.device:
            raise ValueError(f"composite kernel: {name} on {x.device}, sigma on {raw_density.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"composite kernel: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"composite kernel: {name} must be contiguous")
    weights = torch.empty_like(raw_density)
    acc = torch.empty((N,), dtype=torch.float32, device=raw_density.device)
    stream = torch.cuda.current_stream(raw_density.device).cuda_stream
    err = _LIB.function()(
        raw_density.data_ptr(), depths.data_ptr(), dir_norms.data_ptr(),
        weights.data_ptr(), acc.data_ptr(), N, S, stream,
    )
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err}")
    tracing.count("composite.LAUNCHES", device=raw_density.device)
    tracing.count("composite.LAUNCHED_SHAPES", {(N, S)}, raw_density.device)
    return weights, acc


class _CompositeWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw_density, depths, dir_norms):
        ctx.save_for_backward(raw_density, depths, dir_norms)
        if raw_density.device.type == "cpu":
            return composite_weights_reference(raw_density, depths, dir_norms)
        if raw_density.device.type != "cuda":
            raise ValueError(f"composite_weights: unsupported device {raw_density.device}")
        return composite_weights_kernel(raw_density, depths, dir_norms)

    @staticmethod
    def backward(ctx, grad_weights, grad_acc):
        inputs = [
            x.detach().requires_grad_(need) for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)
        ]
        wanted = [x for x in inputs if x.requires_grad]
        if not wanted:
            return None, None, None
        with torch.enable_grad():
            outs = composite_weights_reference(*inputs)
        # cumprod's backward reads on the host whether any input is zero: one sync
        grads = iter(tracing.synced("composite.backward",
                                    lambda: torch.autograd.grad(outs, wanted, (grad_weights, grad_acc))))
        return tuple(next(grads) if x.requires_grad else None for x in inputs)


def composite_weights(
    raw_density: torch.Tensor, depths: torch.Tensor, dir_norms: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights [N, S], acc [N]): the kernel on CUDA tensors, the plain
    version on CPU tensors; differentiable in all three inputs."""
    return _CompositeWeights.apply(raw_density, depths, dir_norms)


def fused_shade_composite(grid, sampled, rays, config, generator=None, extra_debug=False, density_noise=None):
    """Render tail of `render_sh_voxel_grid` when `config.use_fused_kernel`:
    grid query + SH shading, then the compositing kernel. Produces the same
    RenderOut as the plain path. Debug extras and density noise take the
    plain path, as in the JAX package."""
    from voxe_tpu_torch.render.accumulate import (
        RenderOut,
        accumulate_radiance_density_on_rays,
        safe_disparity,
    )
    from voxe_tpu_torch.render.process import process_points_with_sh_voxel_grid
    from voxe_tpu_torch.utils.constants import EXTRA_ACCUMULATED_WEIGHTS, EXTRA_DISPARITY

    processed = process_points_with_sh_voxel_grid(
        sampled, rays, grid, render_diffuse=config.render_diffuse
    )
    if extra_debug or config.stochastic_density_noise_std > 0.0:
        return accumulate_radiance_density_on_rays(
            processed,
            sampled.depths,
            rays,
            stochastic_density_noise_std=config.stochastic_density_noise_std,
            white_bkgd=config.white_bkgd,
            background_value=1.0,
            extra_debug_info=extra_debug,
            generator=generator,
            density_noise=density_noise,
        )
    raw_radiance = processed[..., :-1]
    raw_density = processed[..., -1].contiguous()
    dir_norms = torch.linalg.norm(rays.directions.reshape(-1, 3), dim=-1)

    weights, acc = composite_weights(raw_density, sampled.depths.contiguous(), dir_norms)

    colour = torch.sigmoid(raw_radiance)
    colour_render = torch.sum(colour * weights[..., None], dim=-2)
    acc_render = acc[:, None]
    if config.white_bkgd:
        colour_render = colour_render + (1.0 - acc_render)
    depth_render = torch.sum(sampled.depths * weights, dim=-1, keepdim=True)
    return RenderOut(
        colour=colour_render,
        depth=depth_render,
        extra={
            EXTRA_DISPARITY: safe_disparity(depth_render, acc_render),
            EXTRA_ACCUMULATED_WEIGHTS: acc_render,
        },
    )

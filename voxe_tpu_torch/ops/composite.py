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
package's custom VJP does, so the backward launches no kernel. The exact
renderer's fused tail (`fused_shade_composite`) takes it.

`composite_render` is the shear-warp monolithic tail's whole compositing
pass, from the masked density and the shaded radiance to colour, depth and
acc, once a render. On CUDA tensors it is one `torch.autograd.Function`:
its forward runs the kernel above at the lane-padded [N, S] and then
`csrc/composite_sums.cu` (the colour and depth sums), and its backward is
one launch of `csrc/composite_bwd.cu` (the density's and the radiance's
gradients together, the density's skipped when not wanted). On CPU tensors
it is the plain version, differentiated by autograd.

`LAUNCHES` counts launches of the weights kernel and nothing else;
`LAUNCHED_SHAPES` holds the [N, S] of every such launch since import;
`LAUNCHES_SUMS` and `LAUNCHES_BWD` count the sums and backward kernels'
launches; `LAUNCHED_BWD_SHAPES` holds (N, S, C, radiance bytes a value,
dsigma written, dradiance written) of every backward launch. All are
program counters (`voxe_tpu_torch/utils/tracing.py::count`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from voxe_tpu_torch.ops.cuda_build import CudaLibrary
from voxe_tpu_torch.utils import tracing
from voxe_tpu_torch.utils.constants import INFINITY

_LIB = CudaLibrary(
    "composite_fwd.cu", "voxe_composite_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)
_SUMS_LIB = CudaLibrary(
    "composite_sums.cu", "voxe_composite_sums",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)
_BWD_LIB = CudaLibrary(
    "composite_bwd.cu", "voxe_composite_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)
LANE = 128  # composite_render pads the sample axis to this multiple, as the JAX package does
MAX_CHANNELS = 6  # the sums and backward kernels' largest C (kMaxChannels)
_RADIANCE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = 0  # weights kernel launches since import
LAUNCHED_SHAPES = set()  # (N, S) of every weights launch since import
LAUNCHES_SUMS = 0  # sums kernel launches since import
LAUNCHES_BWD = 0  # backward kernel launches since import
LAUNCHED_BWD_SHAPES = set()  # (N, S, C, radiance itemsize, dsigma, dradiance) of every backward launch


def build(verbose: bool = False):
    """Compile the kernels (once per source content) and return the weights
    kernel's library path. `verbose` prints ptxas' report when a build
    happens."""
    _SUMS_LIB.build(verbose)
    _BWD_LIB.build(verbose)
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


def pad_samples(sigma: torch.Tensor, depths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the sample axis to a multiple of LANE, by at least one sample,
    with zero-density samples whose depths continue at the last spacing:
    the weights kernel's next-depth difference then gives the last real
    sample the slab interval (the volume ends at its far face)."""
    pad = LANE - depths.shape[-1] % LANE
    last = depths[..., -1:]
    spacing = depths[..., -1:] - depths[..., -2:-1]
    ks = torch.arange(1, pad + 1, dtype=depths.dtype, device=depths.device)
    depths_p = torch.cat([depths, last + spacing * ks], dim=-1)
    sigma_p = torch.cat([sigma, sigma.new_zeros((*sigma.shape[:-1], pad))], dim=-1)
    return sigma_p, depths_p


def composite_render_reference(
    sigma: torch.Tensor,  # [N, S] f32 masked density
    depths: torch.Tensor,  # [N, S]
    dir_norms: torch.Tensor,  # [N]
    radiance: torch.Tensor,  # [N, S, C] before the sigmoid
    inside: torch.Tensor,  # [N, S] bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `composite_render`: the lane padding with the slab
    spacing, the weights (`composite_weights`: on a card the weights kernel,
    differentiated through its plain version), then the colour sum with the
    weights in the radiance dtype (products and sum in f32, as the JAX
    einsum with preferred_element_type) and the depth sum. (colour [N, C]
    f32, depth [N, 1], acc [N, 1])."""
    dens_p, depths_p = pad_samples(sigma, depths)
    weights, acc = composite_weights(dens_p, depths_p, dir_norms)
    return (*composite_sums_reference(weights, depths, radiance, inside), acc[..., None])


def composite_sums_reference(
    weights: torch.Tensor, depths: torch.Tensor, radiance: torch.Tensor, inside: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the sums kernel: (colour [N, C] f32, depth [N, 1])
    from the first S of each row of the padded weights [N, >= S]."""
    weights = weights[..., : depths.shape[-1]]
    outside = torch.full((), -INFINITY, dtype=radiance.dtype, device=radiance.device)
    colour = torch.sigmoid(torch.where(inside[..., None], radiance, outside))
    colour_render = torch.einsum("...s,...sc->...c", weights.to(colour.dtype).float(), colour.float())
    return colour_render, torch.sum(depths * weights, dim=-1, keepdim=True)


def _check_render_inputs(sigma, depths, dir_norms, radiance, inside) -> None:
    """What the sums and backward kernels take: f32 [N, S] sigma and depths
    (S >= 2), f32 [N] dir_norms, f32 or bf16 [N, S, C] radiance with 1 <= C
    <= MAX_CHANNELS, bool [N, S] inside; contiguous, on one card."""
    if sigma.dim() != 2 or depths.shape != sigma.shape or inside.shape != sigma.shape:
        raise ValueError(
            f"composite_render: sigma, depths and inside must be one [N, S] shape, got "
            f"{tuple(sigma.shape)}, {tuple(depths.shape)} and {tuple(inside.shape)}"
        )
    N, S = sigma.shape
    if N == 0 or S < 2:
        raise ValueError(f"composite_render: needs N >= 1 rays of S >= 2 samples, got [{N}, {S}]")
    if dir_norms.shape != (N,):
        raise ValueError(f"composite_render: dir_norms must be [{N}], got {tuple(dir_norms.shape)}")
    if radiance.dim() != 3 or radiance.shape[:2] != sigma.shape or not 1 <= radiance.shape[2] <= MAX_CHANNELS:
        raise ValueError(f"composite_render: radiance must be [{N}, {S}, 1..{MAX_CHANNELS}], got {tuple(radiance.shape)}")
    dtypes = (("sigma", sigma, (torch.float32,)), ("depths", depths, (torch.float32,)),
              ("dir_norms", dir_norms, (torch.float32,)), ("radiance", radiance, tuple(_RADIANCE_DTYPES)),
              ("inside", inside, (torch.bool,)))
    for name, x, allowed in dtypes:
        if x.device.type != "cuda" or x.device != sigma.device:
            raise ValueError(f"composite_render: {name} on {x.device}, sigma on {sigma.device}")
        if x.dtype not in allowed:
            raise ValueError(f"composite_render: {name} must be {' or '.join(map(str, allowed))}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"composite_render: {name} must be contiguous")


def composite_sums_kernel(
    weights: torch.Tensor, depths: torch.Tensor, radiance: torch.Tensor, inside: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the sums kernel: (colour [N, C] f32, depth [N, 1] f32) from the
    weights kernel's [N, ld >= S] output and the render's inputs."""
    N, S = depths.shape
    C = radiance.shape[2]
    if weights.shape[0] != N or weights.shape[1] < S or weights.dtype != torch.float32 or not weights.is_contiguous():
        raise ValueError(f"composite_sums: weights must be contiguous f32 [{N}, >= {S}], got {tuple(weights.shape)}")
    colour = torch.empty((N, C), dtype=torch.float32, device=depths.device)
    depth = torch.empty((N, 1), dtype=torch.float32, device=depths.device)
    stream = torch.cuda.current_stream(depths.device).cuda_stream
    err = _SUMS_LIB.function()(
        weights.data_ptr(), depths.data_ptr(), radiance.data_ptr(), inside.data_ptr(), colour.data_ptr(),
        depth.data_ptr(), weights.shape[1], N, S, C, _RADIANCE_DTYPES[radiance.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"composite_sums launch failed: CUDA error {err}")
    tracing.count("composite.LAUNCHES_SUMS", device=depths.device)
    return colour, depth


def composite_bwd_kernel(
    sigma, depths, dir_norms, radiance, inside, g_colour, g_depth, g_acc, want_sigma: bool, want_radiance: bool
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the backward kernel: (dsigma [N, S] f32 or None, dradiance
    [N, S, C] in radiance's dtype or None) from the upstream gradients
    g_colour [N, C], g_depth and g_acc [N] (f32)."""
    N, S = sigma.shape
    C = radiance.shape[2]
    grads = (g_colour, g_depth, g_acc)
    if g_colour.shape != (N, C) or g_depth.shape != (N,) or g_acc.shape != (N,) or any(
        g.dtype != torch.float32 or not g.is_contiguous() or g.device != sigma.device for g in grads
    ):
        raise ValueError("composite_bwd: the upstream gradients must be contiguous f32 [N, C], [N] and [N]")
    dsigma = torch.empty_like(sigma) if want_sigma else None
    dradiance = torch.empty_like(radiance) if want_radiance else None
    stream = torch.cuda.current_stream(sigma.device).cuda_stream
    err = _BWD_LIB.function()(
        sigma.data_ptr(), depths.data_ptr(), dir_norms.data_ptr(), radiance.data_ptr(), inside.data_ptr(),
        g_colour.data_ptr(), g_depth.data_ptr(), g_acc.data_ptr(),
        None if dsigma is None else dsigma.data_ptr(), None if dradiance is None else dradiance.data_ptr(),
        N, S, C, _RADIANCE_DTYPES[radiance.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"composite_bwd launch failed: CUDA error {err}")
    tracing.count("composite.LAUNCHES_BWD", device=sigma.device)
    shape = (N, S, C, radiance.element_size(), want_sigma, want_radiance)
    tracing.count("composite.LAUNCHED_BWD_SHAPES", {shape}, sigma.device)
    return dsigma, dradiance


class _CompositeRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, depths, dir_norms, radiance, inside):
        dens_p, depths_p = pad_samples(sigma, depths)
        weights, acc = composite_weights_kernel(dens_p, depths_p, dir_norms)
        colour, depth = composite_sums_kernel(weights, depths, radiance, inside)
        ctx.save_for_backward(sigma, depths, dir_norms, radiance, inside)
        return colour, depth, acc[:, None]

    @staticmethod
    def backward(ctx, g_colour, g_depth, g_acc):
        want_sigma, _, _, want_radiance, _ = ctx.needs_input_grad
        if not (want_sigma or want_radiance):
            return None, None, None, None, None
        dsigma, dradiance = composite_bwd_kernel(
            *ctx.saved_tensors, g_colour.contiguous(), g_depth.reshape(-1).contiguous(),
            g_acc.reshape(-1).contiguous(), want_sigma, want_radiance,
        )
        return dsigma, None, None, dradiance, None


def composite_render(
    sigma: torch.Tensor, depths: torch.Tensor, dir_norms: torch.Tensor, radiance: torch.Tensor, inside: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(colour [N, C] f32, depth [N, 1], acc [N, 1]) of the slab-padded
    composite of `radiance` ([N, S, C] before the sigmoid, 0 outside
    `inside` after it) over the masked density `sigma` ([N, S] f32) at
    `depths` ([N, S]) along rays of direction norm `dir_norms` ([N]):
    `composite_render_reference`'s numbers. On CUDA tensors the kernels,
    differentiable in sigma and radiance (depths and dir_norms are the
    render's geometry: a gradient there raises); on CPU tensors the plain
    version."""
    if sigma.device.type == "cpu":
        return composite_render_reference(sigma, depths, dir_norms, radiance, inside)
    if torch.is_grad_enabled() and (depths.requires_grad or dir_norms.requires_grad):
        raise ValueError("composite_render: depths and dir_norms take no gradient on a card")
    _check_render_inputs(sigma, depths, dir_norms, radiance, inside)
    return _CompositeRender.apply(sigma, depths, dir_norms, radiance, inside)


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

"""SDS edit trainer on the shear-warp path (counterpart of
voxe_tpu/train/sds.py: `make_sds_train_step_shearwarp` and
`make_sds_train_multi_step(use_shear_warp=True)`).

One step: render the base-plane frame of the grid from a pose, orient it
upright, SDS loss through VAE encode + CFG UNet, density-correlation (and
optional feature/TV) losses, backward, one optimizer step. The optimizer is
a `torch.optim.Adam` over the grid's `densities` and `features`, which it
updates in place (optax.adam's update: lr * m_hat / (sqrt(v_hat) + eps)).
There is no jit here: the JAX `lax.scan` over K steps is a Python loop; the
pose, the direction bucket and t are drawn from a `torch.Generator`.

Not ported yet: the exact-renderer steps, the dataset-pose variants and the
CLI.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from voxe_tpu_torch.grid.voxels import VoxelGrid
from voxe_tpu_torch.models.sd.sds import StableDiffusion
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.render.shearwarp import orient_base_image, render_shear_warp
from voxe_tpu_torch.train.losses import (
    density_correlation_loss_fn,
    feature_correlation_loss,
    tv_loss_on_grid,
)
from voxe_tpu_torch.utils.camera import CameraPose, direction_index, random_pose

HEMISPHERICAL_RADIUS_CONSTANT = 4.0311  # reference sds_trainer.py:45


def make_adam(grid: VoxelGrid, lr: float) -> torch.optim.Adam:
    """Adam over the grid's trainable tensors, with optax.adam's defaults
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root)."""
    grid.densities.requires_grad_(True)
    grid.features.requires_grad_(True)
    return torch.optim.Adam([grid.densities, grid.features], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def sds_edit_loss(
    grid: VoxelGrid,
    sd: StableDiffusion,
    render_config: SHVoxGridRenderConfig,
    base_hw: tuple,
    text_embeddings: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    ref_densities: torch.Tensor,
    ref_features: torch.Tensor,
    t,
    *,
    do_sds: bool = True,
    guidance_scale: float = 100.0,
    density_correlation_weight: float = 0.0,
    feature_correlation_weight: float = 0.0,
    tv_density_weight: float = 0.0,
    tv_features_weight: float = 0.0,
    l2_mode: bool = False,
    l1_mode: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    vae_eps: Optional[torch.Tensor] = None,
):
    """The edit step's loss (the JAX `loss_fn`): (total, metrics)."""
    out, _ = render_shear_warp(
        grid, CameraPose(rotation, translation.reshape(3, 1)), render_config, base_hw=base_hw
    )
    total = torch.zeros((), device=grid.densities.device)
    metrics = {}
    if do_sds:
        # upright frame for SD (rows down camera -up, cols along right)
        imgs = orient_base_image(out.colour.reshape(*base_hw, 3), rotation)[None]
        total = total + sd.sds_loss(
            text_embeddings, imgs, t, guidance_scale,
            generator=generator, noise=noise, vae_eps=vae_eps,
        )
    dcl, _ = density_correlation_loss_fn(
        grid.densities, ref_densities, l2_mode=l2_mode, l1_mode=l1_mode
    )
    total = total + dcl * density_correlation_weight
    metrics["density_correlation_loss"] = dcl.detach()
    if feature_correlation_weight > 0.0:
        fcl = feature_correlation_loss(grid.features, ref_features)
        total = total + fcl * feature_correlation_weight
        metrics["feature_correlation_loss"] = fcl.detach()
    if tv_density_weight > 0.0:
        tv_d = tv_loss_on_grid(torch.relu(grid.densities))
        total = total + tv_d * tv_density_weight
        metrics["tv_density_loss"] = tv_d.detach()
    if tv_features_weight > 0.0:
        tv_f = tv_loss_on_grid(grid.features)
        total = total + tv_f * tv_features_weight
        metrics["tv_features_loss"] = tv_f.detach()
    return total, metrics


def make_sds_train_step_shearwarp(
    sd: StableDiffusion,
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    base_hw: tuple,
    **loss_kwargs,
) -> Callable:
    """The edit step on the shear-warp path.

    signature: step(grid, text_embeddings [2,77,D], rotation [3,3],
                    translation [3,1], ref_densities, ref_features, t,
                    *, generator=None, noise=None, vae_eps=None) -> metrics
    The grid is updated in place by `optimizer`."""
    base_hw = tuple(base_hw)

    def step(
        grid, text_embeddings, rotation, translation, ref_densities, ref_features, t,
        *, generator=None, noise=None, vae_eps=None,
    ):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = sds_edit_loss(
            grid, sd, render_config, base_hw, text_embeddings, rotation, translation,
            ref_densities, ref_features, t,
            generator=generator, noise=noise, vae_eps=vae_eps, **loss_kwargs,
        )
        total.backward()
        optimizer.step()
        metrics["total_loss"] = total.detach()
        return metrics

    return step


def make_sds_train_multi_step(
    sd: StableDiffusion,
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    intrinsics,  # CameraIntrinsics
    steps_per_call: int,
    *,
    radius: float = HEMISPHERICAL_RADIUS_CONSTANT,
    use_shear_warp: bool = False,
    sw_base_hw: Optional[tuple] = None,
    **loss_kwargs,
) -> Callable:
    """K SDS edit steps per call (random-pose mode): each step draws a
    hemisphere pose, buckets its view direction to pick the text
    embeddings, draws t in [t_lo, t_hi], and takes one edit step.

    signature: multi_step(grid, text_embeddings_by_dir [4, 2, 77, D],
                          ref_densities, ref_features, t_bounds [K, 2],
                          generator) -> last step's metrics
    """
    if not use_shear_warp:
        raise NotImplementedError("the exact-renderer edit step is not ported yet")
    base_hw = tuple(sw_base_hw) if sw_base_hw is not None else (
        intrinsics.height, intrinsics.width
    )
    step = make_sds_train_step_shearwarp(sd, render_config, optimizer, base_hw, **loss_kwargs)

    def multi_step(grid, text_by_dir, ref_densities, ref_features, t_bounds, generator):
        t_bounds = torch.as_tensor(t_bounds).cpu()
        if t_bounds.shape != (steps_per_call, 2):
            raise ValueError(f"t_bounds must be [{steps_per_call}, 2], got {tuple(t_bounds.shape)}")
        metrics = {}
        for i in range(steps_per_call):
            rotation, translation, pitch_deg, yaw_deg = random_pose(
                generator, radius, device=grid.densities.device
            )
            dir_idx = direction_index(float(pitch_deg), float(yaw_deg))
            t_lo, t_hi = int(t_bounds[i, 0]), int(t_bounds[i, 1])
            t = int(torch.randint(
                t_lo, t_hi + 1, (), generator=generator, device=generator.device
            ))
            metrics = step(
                grid, text_by_dir[dir_idx], rotation, translation,
                ref_densities, ref_features, t, generator=generator,
            )
            metrics["dir_idx"] = dir_idx
            metrics["t"] = t
        return metrics

    return multi_step

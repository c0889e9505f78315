"""Reconstruction trainer: fit an SH voxel grid to posed images
(counterpart of voxe_tpu/train/recon.py).

Two steps, each one call that renders, takes the L1 losses, runs the
backward and one Adam update of the grid in place:

- the exact ray-batch step (`make_recon_train_step`): random pixels of an
  image batch, rays cast only for them, one grid query feeding both the
  full-SH and the diffuse (degree-0) composites;
- the shear-warp step (`make_recon_train_step_shearwarp`): one whole
  base-plane frame per step against targets splatted onto the base lattice
  once per stage (`warp_dataset_to_base`). With `use_fused_kernel` its two
  composites (specular and diffuse) go through the compositing kernel.

The JAX package draws ray indices and jitter with `jax.random`; here they
come from a `torch.Generator`, and tests may inject them. The image index of
the shear-warp step is drawn from a numpy Generator, as in the JAX trainer.
`train_sh_vox_grid_vol_mod_with_posed_images` runs the stage ladder; unless
`fast_debug_mode`, it draws the camera rays once, renders feedback PNGs
every `feedback_freq` steps and tests on the held-out set every `test_freq`
steps, both left out of the training time. Not ported yet: `steps_per_call
> 1`, `num_devices > 1`, streaming datasets, `coarse_stages_on_cpu` and
`resume_from`.
"""
from __future__ import annotations

import time
from datetime import timedelta
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.grid.voxels import VoxelGrid, grid_query, scale_voxel_grid
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.render.accumulate import accumulate_radiance_density_on_rays
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig, _sample
from voxe_tpu_torch.render.process import _shade_and_mask
from voxe_tpu_torch.render.rays import Rays
from voxe_tpu_torch.render.shearwarp import (
    check_shear_warp_poses,
    compute_base_geometry,
    lane_aligned_res,
    render_shear_warp,
    screen_to_base,
    warp_image_to_base,
)
from voxe_tpu_torch.train.checkpointing import adam_state_tensors, save_training_state
from voxe_tpu_torch.utils.camera import CameraIntrinsics, CameraPose
from voxe_tpu_torch.utils.constants import (
    CAMERA_BOUNDS,
    CAMERA_INTRINSICS,
    HEMISPHERICAL_RADIUS,
    NUM_COLOUR_CHANNELS,
)
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.metrics import mse2psnr
from voxe_tpu_torch.utils.misc import compute_thre3d_grid_sizes


def cast_rays_at_indices(intrinsics: CameraIntrinsics, poses: torch.Tensor, flat_indices: torch.Tensor) -> Rays:
    """Cast only the rays addressed by flat (image, pixel) indices into
    B*H*W; poses [B, 3, 4]."""
    height, width, focal = intrinsics
    pixels_per_image = height * width
    img_idx = flat_indices // pixels_per_image
    pix_idx = flat_indices % pixels_per_image
    y = (pix_idx // width).float() + 0.5
    x = (pix_idx % width).float() + 0.5
    dirs = torch.stack([(x - width * 0.5) / focal, -(y - height * 0.5) / focal, -torch.ones_like(x)], dim=-1)
    rot = poses[img_idx, :, :3]
    trans = poses[img_idx, :, 3]
    return Rays(trans, torch.einsum("rij,rj->ri", rot, dirs))


def render_specular_and_diffuse(
    grid: VoxelGrid,
    rays: Rays,
    config: SHVoxGridRenderConfig,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
):
    """One grid query -> two composited renders (full SH, diffuse deg-0)."""
    sampled = _sample(grid, rays, config, generator, t_rand)
    num_samples = sampled.points.shape[1]
    flat_points = sampled.points.reshape(-1, 3)
    interpolated = grid_query(grid, flat_points)
    outs = []
    for diffuse in (False, True):
        processed = _shade_and_mask(
            grid, flat_points, interpolated, rays, num_samples, NUM_COLOUR_CHANNELS, render_diffuse=diffuse
        )
        outs.append(accumulate_radiance_density_on_rays(processed, sampled.depths, rays, white_bkgd=config.white_bkgd))
    return tuple(outs)


def photometric_losses(colour, diffuse_colour, target, apply_diffuse: bool, mask=None, denom=None):
    """L1 losses (the objective) and the MSE-derived PSNRs, optionally
    masked and divided by `denom` (the shear-warp step's base coverage)."""
    def mean(x):
        return x.mean() if mask is None else (x * mask).sum() / denom

    spec_l1 = mean(torch.abs(colour - target))
    spec_mse = mean((colour - target) ** 2)
    total = spec_l1
    diff_l1 = diff_mse = torch.zeros((), device=colour.device)
    if apply_diffuse:
        diff_l1 = mean(torch.abs(diffuse_colour - target))
        diff_mse = mean((diffuse_colour - target) ** 2)
        total = total + diff_l1
    metrics = dict(
        specular_loss=spec_l1.detach(),
        diffuse_loss=diff_l1.detach(),
        specular_psnr=mse2psnr(spec_mse.detach()),
        diffuse_psnr=mse2psnr(diff_mse.detach()),
    )
    return total, metrics


def make_adam(grid: VoxelGrid, lr: float) -> torch.optim.Adam:
    """Adam over the grid's trainable tensors, with optax.adam's defaults
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root)."""
    grid.densities.requires_grad_(True)
    grid.features.requires_grad_(True)
    return torch.optim.Adam([grid.densities, grid.features], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def apply_lr_schedule(optimizer: torch.optim.Optimizer, lr_schedule) -> None:
    """Set the lr of `lr_schedule` (None: leave it) for the optimizer's count
    of earlier updates, which is what optax schedules read."""
    if lr_schedule is None:
        return
    first = optimizer.param_groups[0]["params"][0]
    count = int(optimizer.state[first]["step"]) if first in optimizer.state else 0
    for group in optimizer.param_groups:
        group["lr"] = lr_schedule(count)


def optimizer_step(optimizer: torch.optim.Optimizer, total: torch.Tensor, metrics: dict, lr_schedule) -> dict:
    """Backward of `total`, the lr of the schedule, one update; returns
    `metrics` with total_loss."""
    total.backward()
    apply_lr_schedule(optimizer, lr_schedule)
    optimizer.step()
    metrics["total_loss"] = total.detach()
    return metrics


def exponential_decay_staircase(
    init_value: float, transition_steps: int, decay_rate: float, transition_begin: int = 0
):
    """optax.exponential_decay(staircase=True): lr after `count` updates."""

    def schedule(count: int) -> float:
        decreased = count - transition_begin
        return init_value if decreased <= 0 else init_value * decay_rate ** (decreased // transition_steps)

    return schedule


def make_recon_train_step(
    intrinsics: CameraIntrinsics,
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    ray_batch_size: int,
    apply_diffuse_render_regularization: bool = True,
    lr_schedule=None,
) -> Callable:
    """The exact ray-batch update.

    signature: step(grid, images [N,H,W,3], poses [N,3,4], batch_indices [B],
                    generator, *, flat_idx=None, t_rand=None) -> metrics
    `flat_idx` ([R] into B*H*W) and `t_rand` ([R, S]) replace the draws."""

    def step(grid, images, poses, batch_indices, generator=None, *, flat_idx=None, t_rand=None):
        batch_indices = torch.as_tensor(batch_indices, device=images.device)
        batch_images, batch_poses = images[batch_indices], poses[batch_indices]
        total_pixels = batch_images.shape[0] * batch_images.shape[1] * batch_images.shape[2]
        if flat_idx is None:
            flat_idx = torch.randint(0, total_pixels, (ray_batch_size,), generator=generator, device=generator.device)
        flat_idx = torch.as_tensor(flat_idx, device=images.device)
        pixels = batch_images.reshape(-1, 3)[flat_idx]
        rays = cast_rays_at_indices(intrinsics, batch_poses, flat_idx)
        optimizer.zero_grad(set_to_none=True)
        out_spec, out_diff = render_specular_and_diffuse(grid, rays, render_config, generator, t_rand)
        total, metrics = photometric_losses(
            out_spec.colour, out_diff.colour, pixels, apply_diffuse_render_regularization
        )
        return optimizer_step(optimizer, total, metrics, lr_schedule)

    return step


def warp_dataset_to_base(images: torch.Tensor, poses, intrinsics: CameraIntrinsics, grid: VoxelGrid, base_hw):
    """Splat every target image onto its pose's base-plane lattice (data
    only, once per stage). Checks first that every pose sees the grid from
    outside along its marching axis. Returns (targets [N, U, V, 3],
    masks [N, U, V]) on the images' device."""
    poses_np = poses.detach().cpu().numpy()
    check_shear_warp_poses(grid, poses_np, "shear-warp training (warp_dataset_to_base)")
    targets, masks = [], []
    for i in range(images.shape[0]):
        pose = CameraPose(rotation=poses_np[i][:, :3], translation=poses_np[i][:, 3:])
        coords = screen_to_base(pose, intrinsics, compute_base_geometry(grid, pose), grid, base_hw)
        t, m = warp_image_to_base(images[i], coords.to(images.device), tuple(base_hw))
        targets.append(t)
        masks.append(m)
    return torch.stack(targets), torch.stack(masks)


def make_recon_train_step_shearwarp(
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    base_hw,
    apply_diffuse_render_regularization: bool = True,
    lr_schedule=None,
) -> Callable:
    """The shear-warp update: one whole base-plane frame per step, L1 in
    base space against the pre-warped target, masked to its coverage.

    signature: step(grid, targets [N,U,V,3], masks [N,U,V], poses [N,3,4],
                    image_idx) -> metrics"""
    base_hw = tuple(base_hw)

    def step(grid, targets, masks, poses, image_idx):
        image_idx = int(image_idx)
        target, mask, pose_rt = targets[image_idx], masks[image_idx], poses[image_idx]
        pose = CameraPose(rotation=pose_rt[:, :3], translation=pose_rt[:, 3:])
        m = mask[..., None]
        denom = torch.clamp(mask.sum() * NUM_COLOUR_CHANNELS, min=1.0)
        optimizer.zero_grad(set_to_none=True)
        out, _ = render_shear_warp(
            grid, pose, render_config, base_hw=base_hw, with_diffuse=apply_diffuse_render_regularization
        )
        img = out.colour.reshape(*base_hw, NUM_COLOUR_CHANNELS)
        dimg = out.extra["diffuse_colour"].reshape(*base_hw, NUM_COLOUR_CHANNELS) if (
            apply_diffuse_render_regularization) else None
        total, metrics = photometric_losses(
            img, dimg, target, apply_diffuse_render_regularization, mask=m, denom=denom
        )
        return optimizer_step(optimizer, total, metrics, lr_schedule)

    return step


def _unsupported(**options) -> None:
    for name, (value, default) in options.items():
        if value != default:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")


def train_sh_vox_grid_vol_mod_with_posed_images(
    vol_mod: VolumetricModel,
    train_dataset: PosedImagesDataset,
    output_dir: Path,
    test_dataset: Optional[PosedImagesDataset] = None,
    image_batch_cache_size: int = 8,
    ray_batch_size: int = 32768,
    num_stages: int = 4,
    num_iterations_per_stage: int = 2000,
    scale_factor: float = 2.0,
    learning_rate: float = 0.03,
    lr_decay_gamma_per_stage: float = 0.1,
    lr_decay_steps_per_stage: int = 1000,
    stagewise_lr_decay_gamma: float = 0.9,
    render_feedback_pose: Optional[CameraPose] = None,
    save_freq: int = 1000,
    test_freq: int = 1000,
    feedback_freq: int = 100,
    summary_freq: int = 10,
    apply_diffuse_render_regularization: bool = True,
    verbose_rendering: bool = True,
    fast_debug_mode: bool = False,
    seed: int = 42,
    grid_random_init_range: tuple = (-1.0, 1.0),
    num_devices: int = 1,
    resume_from: Optional[Path] = None,
    steps_per_call: int = 1,
    coarse_stages_on_cpu: bool = False,
    coarse_ray_batch_size: Optional[int] = None,
    use_shear_warp: bool = False,
    shear_warp_base_res: Optional[int] = None,
) -> VolumetricModel:
    """Multi-stage coarse-to-fine reconstruction on the grid's device.

    Each stage trains a grid of the stage's size on the dataset downsampled
    for it, with Adam at lr `learning_rate * stagewise_lr_decay_gamma **
    (stage - 1)` decayed by `lr_decay_gamma_per_stage` every
    `lr_decay_steps_per_stage` updates, then upsamples the grid. Snapshots go
    to `output_dir/saved_models`, ending with `model_final.pth`; feedback
    PNGs to `output_dir/training_logs/rendered_output` (from
    `render_feedback_pose`, by default the first test, else train, pose);
    scalars to `training_logs/tensorboard` when tensorboardX imports."""
    _unsupported(
        num_devices=(num_devices, 1), resume_from=(resume_from, None),
        steps_per_call=(steps_per_call, 1), coarse_stages_on_cpu=(coarse_stages_on_cpu, False),
    )
    del verbose_rendering, coarse_ray_batch_size
    output_dir = Path(output_dir)
    model_dir = output_dir / "saved_models"
    logs_dir = output_dir / "training_logs"
    render_dir = logs_dir / "rendered_output"
    for d in (model_dir, logs_dir, render_dir):
        d.mkdir(parents=True, exist_ok=True)
    try:
        from tensorboardX import SummaryWriter

        tb_writer = SummaryWriter(str(logs_dir / "tensorboard"))
    except ImportError:
        tb_writer = None
    dev = vol_mod.grid.densities.device

    final_dims = vol_mod.grid.grid_dims
    stagewise_sizes = compute_thre3d_grid_sizes(final_dims, num_stages, scale_factor)
    dataset_config = train_dataset.get_config_dict()
    base_downsample = dataset_config["downsample_factor"]
    stagewise_datasets = [train_dataset]
    for stage in range(1, num_stages):
        cfg = dict(dataset_config)
        cfg["downsample_factor"] = base_downsample * (scale_factor**stage)
        stagewise_datasets.insert(0, PosedImagesDataset(**cfg))

    # start from scratch at the coarsest stage: uniform random init
    gen = torch.Generator(device=dev).manual_seed(seed)
    grid = scale_voxel_grid(vol_mod.grid, stagewise_sizes[0])
    lo, hi = grid_random_init_range
    grid = grid.replace(
        densities=torch.rand(grid.densities.shape, generator=gen, device=dev) * (hi - lo) + lo,
        features=torch.rand(grid.features.shape, generator=gen, device=dev) * (hi - lo) + lo,
    )

    if render_feedback_pose is None:
        pose0 = (test_dataset if test_dataset is not None else train_dataset).poses[0]
        render_feedback_pose = CameraPose(rotation=pose0[:, :3], translation=pose0[:, 3:])
    camera_intrinsics = train_dataset.camera_intrinsics
    extra_info = {
        CAMERA_BOUNDS: list(train_dataset.camera_bounds),
        CAMERA_INTRINSICS: list(camera_intrinsics),
        HEMISPHERICAL_RADIUS: train_dataset.get_hemispherical_radius_estimate(),
    }
    if not fast_debug_mode:
        from voxe_tpu_torch.viz.static import visualize_camera_rays

        log.info("creating a camera-rays visualization ...")
        visualize_camera_rays(train_dataset, output_dir, num_rays_per_image=1)
    rng = np.random.default_rng(seed)
    log.info("beginning reconstruction training")
    time_training = 0.0
    global_step = 0
    for stage in range(1, num_stages + 1):
        stage_dataset = stagewise_datasets[stage - 1]
        intr = stage_dataset.camera_intrinsics
        images, poses = stage_dataset.device_arrays()
        batch_iter = stage_dataset.iter_batches(image_batch_cache_size, rng)
        stage_lr = learning_rate * (stagewise_lr_decay_gamma ** (stage - 1))
        schedule = exponential_decay_staircase(stage_lr, lr_decay_steps_per_stage, lr_decay_gamma_per_stage)
        optimizer = make_adam(grid, stage_lr)
        render_config = vol_mod.render_config
        if use_shear_warp:
            base_res = shear_warp_base_res or lane_aligned_res(2 * max(intr.height, intr.width))
            base_hw = (base_res, base_res)
            log.info(f"shear-warp path: base lattice {base_hw}")
            sw_targets, sw_masks = warp_dataset_to_base(images, poses, intr, grid, base_hw)
            train_step = make_recon_train_step_shearwarp(
                render_config, optimizer, base_hw, apply_diffuse_render_regularization, lr_schedule=schedule
            )
        else:
            stage_ray_batch = min(ray_batch_size, image_batch_cache_size * intr.height * intr.width)
            train_step = make_recon_train_step(
                intr, render_config, optimizer, stage_ray_batch, apply_diffuse_render_regularization,
                lr_schedule=schedule,
            )
        log.info(
            f"training stage: {stage}  grid: {grid.grid_dims}  images: [{intr.height} x {intr.width}]  "
            f"lr: {stage_lr:.5f}"
        )
        stage_time_start, stage_wall_start = time_training, time.perf_counter()
        feedback_s = test_s = 0.0
        last_time = time.perf_counter()
        for stage_iteration in range(1, num_iterations_per_stage + 1):
            if use_shear_warp:
                idx = int(rng.integers(0, len(stage_dataset)))
                metrics = train_step(grid, sw_targets, sw_masks, poses, idx)
            else:
                metrics = train_step(grid, images, poses, next(batch_iter), gen)
            global_step += 1
            last_iter = stage_iteration == num_iterations_per_stage
            if global_step % summary_freq == 0 or stage_iteration == 1 or last_iter:
                metrics_host = {k: float(v) for k, v in metrics.items()}
                time_training += time.perf_counter() - last_time
                log.info(
                    f"Stage: {stage} Global: {global_step} "
                    + " ".join(f"{k}: {v:.3f}" for k, v in metrics_host.items())
                )
                if tb_writer is not None:
                    for k, v in metrics_host.items():
                        tb_writer.add_scalar(k, v, global_step=global_step)
                last_time = time.perf_counter()
            if (global_step % feedback_freq == 0 or stage_iteration == 1 or last_iter) and not fast_debug_mode:
                from voxe_tpu_torch.viz.static import visualize_sh_vox_grid_vol_mod_rendered_feedback

                t0 = time.perf_counter()
                visualize_sh_vox_grid_vol_mod_rendered_feedback(
                    VolumetricModel(grid, render_config), "default", render_feedback_pose, camera_intrinsics,
                    global_step, render_dir, training_time=time_training, use_shear_warp=use_shear_warp,
                )
                last_time = time.perf_counter()
                feedback_s += last_time - t0
            if test_dataset is not None and not fast_debug_mode and (global_step % test_freq == 0 or last_iter):
                from voxe_tpu_torch.train.testers import test_sh_vox_grid_vol_mod_with_posed_images

                t0 = time.perf_counter()
                test_sh_vox_grid_vol_mod_with_posed_images(
                    VolumetricModel(grid, render_config), test_dataset, tb_writer, global_step
                )
                last_time = time.perf_counter()
                test_s += last_time - t0
            if global_step % save_freq == 0 or stage_iteration == 1 or last_iter:
                frozen = grid.replace(densities=grid.densities.detach(), features=grid.features.detach())
                VolumetricModel(frozen, render_config).save(
                    model_dir / f"model_stage_{stage}_iter_{global_step}.pth", extra_info=extra_info
                )
                save_training_state(
                    model_dir / "training_state_latest.pth",
                    adam_state_tensors(grid, optimizer),
                    {"stage": stage, "stage_iteration": stage_iteration, "global_step": global_step},
                )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        time_training += time.perf_counter() - last_time
        stage_s = time_training - stage_time_start
        log.info(
            f"stage {stage} done: training time {stage_s:.1f}s (synced), wall "
            f"{time.perf_counter() - stage_wall_start:.1f}s incl. feedback {feedback_s:.1f}s, "
            f"test {test_s:.1f}s, logging and checkpoints",
            extra={"stage": stage, "stage_training_s": stage_s, "stage_feedback_s": feedback_s,
                   "stage_test_s": test_s},
        )
        if stage != num_stages:
            with torch.no_grad():
                grid = scale_voxel_grid(grid, stagewise_sizes[stage])

    vol_mod.grid = grid.replace(densities=grid.densities.detach(), features=grid.features.detach())
    vol_mod.extra_info.update(extra_info)
    vol_mod.save(model_dir / "model_final.pth", extra_info=extra_info)
    if tb_writer is not None:
        tb_writer.close()
    log.info(f"Training complete; actual training time: {timedelta(seconds=time_training)}",
             extra={"time_training": time_training})
    return vol_mod

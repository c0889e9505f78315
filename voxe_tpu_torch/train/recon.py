"""Reconstruction trainer: fit an SH voxel grid to posed images
(counterpart of voxe_tpu/train/recon.py).

Three steps, each one call that renders, takes the L1 losses, runs the
backward and one Adam update of the grid in place:

- the exact ray-batch step (`make_recon_train_step`): random pixels of an
  image batch, rays cast only for them, one grid query feeding both the
  full-SH and the diffuse (degree-0) composites;
- the streaming step (`make_recon_train_step_streaming`): the same update
  on pixels the host gathered from a memmap-backed dataset;
- the shear-warp step (`make_recon_train_step_shearwarp`): one whole
  base-plane frame per step against targets splatted onto the base lattice
  once per stage (`warp_dataset_to_base`). With `use_fused_kernel` its two
  composites (specular and diffuse) go through the compositing kernel.

The K-step functions (`make_recon_train_multi_step_shearwarp`,
`make_recon_train_multi_step`) run K of those steps a call, the JAX
package's `steps_per_call`: a Python loop over the same step, since eager
PyTorch has no scan to fuse them into. The JAX package draws ray indices,
image batches and jitter with `jax.random`; here they come from a
`torch.Generator`, and tests may inject them. The shear-warp image indices
and the streaming step's pixels are drawn from a numpy Generator on the
host, as in the JAX trainer. `train_sh_vox_grid_vol_mod_with_posed_images`
runs the stage ladder; unless `fast_debug_mode`, it draws the camera rays
once, renders feedback PNGs every `feedback_freq` steps and tests on the
held-out set every `test_freq` steps, both left out of the training time.
It resumes from a training-state file of either package, runs the coarse
stages on the CPU when asked, and streams a memmap-backed stage.

Every step builder takes a `mesh` (voxe_tpu_torch.parallel) for
data-parallel ray batching, as the JAX one does: each rank draws the whole
step's randomness (ray indices, jitter, density noise), takes its share of
the rays or base rows, divides its losses by the whole batch's count or
coverage, and one all-reduce sums the gradients (and the metrics' shares)
before Adam, so the sharded step is the unsharded one.
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
from voxe_tpu_torch.parallel.distributed import is_local_writer
from voxe_tpu_torch.parallel.mesh import all_reduce_grads, maybe_mesh, params_of, replicate, shard_axis, shard_rays
from voxe_tpu_torch.render.accumulate import accumulate_radiance_density_on_rays
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig, _sample, draw_ray_randomness
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
from voxe_tpu_torch.train.checkpointing import (
    load_training_state,
    read_training_state,
    save_training_state,
    training_state_arrays,
)
from voxe_tpu_torch.utils import tracing
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


@tracing.traced("loss")
def photometric_losses(colour, diffuse_colour, target, apply_diffuse: bool, mask=None, denom=None):
    """(the L1 objective, its metrics: the L1 losses and the MSEs, which
    `psnr_metrics` turns into PSNRs), optionally masked, and divided by
    `denom` (the shear-warp step's base coverage, or a sharded batch's whole
    count) when given: under a mesh each rank's share of every one of them."""
    def mean(x):
        if denom is None:
            return x.mean()
        return (x if mask is None else x * mask).sum() / denom

    spec_l1 = mean(torch.abs(colour - target))
    spec_mse = mean((colour - target) ** 2)
    total = spec_l1
    diff_l1 = diff_mse = torch.zeros((), device=colour.device)
    if apply_diffuse:
        diff_l1 = mean(torch.abs(diffuse_colour - target))
        diff_mse = mean((diffuse_colour - target) ** 2)
        total = total + diff_l1
    sums = dict(
        specular_loss=spec_l1.detach(),
        diffuse_loss=diff_l1.detach(),
        specular_mse=spec_mse.detach(),
        diffuse_mse=diff_mse.detach(),
    )
    return total, sums


def psnr_metrics(sums: dict) -> dict:
    """`photometric_losses`' metrics with each MSE turned into its PSNR."""
    return {("specular_psnr" if k == "specular_mse" else "diffuse_psnr" if k == "diffuse_mse" else k):
            (mse2psnr(v) if k.endswith("_mse") else v) for k, v in sums.items()}


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


def optimizer_step(optimizer: torch.optim.Optimizer, total: torch.Tensor, metrics: dict, lr_schedule,
                   mesh=None, total_share: Optional[torch.Tensor] = None) -> dict:
    """Backward of `total`, the lr of the schedule, one update; returns
    `metrics` with total_loss.

    With `mesh`, every value of `metrics` is this rank's share of the metric
    and `total_share` (by default `total`) its share of the total loss: one
    all-reduce between the backward and the update sums the gradients and
    the shares, so every rank takes the unsharded update and reports the
    unsharded metrics."""
    with tracing.span("backward"):
        if mesh is None:
            total.backward()
            metrics["total_loss"] = total.detach()
        else:
            if total.requires_grad:  # a rank may hold no term with a gradient
                total.backward()
            shares = {**metrics, "total_loss": total if total_share is None else total_share}
            metrics = all_reduce_grads(mesh, params_of([optimizer]), shares)
    with tracing.span("optim"):
        apply_lr_schedule(optimizer, lr_schedule)
        optimizer.step()
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
    mesh=None,
) -> Callable:
    """The exact ray-batch update. With `mesh` each rank renders its share
    of the drawn rays.

    signature: step(grid, images [N,H,W,3], poses [N,3,4], batch_indices [B],
                    generator, *, flat_idx=None, t_rand=None) -> metrics
    `flat_idx` ([R] into B*H*W) and `t_rand` ([R, S]) replace the draws."""
    update = _ray_batch_update(
        intrinsics, render_config, optimizer, apply_diffuse_render_regularization, lr_schedule, mesh
    )

    def step(grid, images, poses, batch_indices, generator=None, *, flat_idx=None, t_rand=None):
        batch_indices = torch.as_tensor(batch_indices, device=images.device)
        batch_images, batch_poses = images[batch_indices], poses[batch_indices]
        total_pixels = batch_images.shape[0] * batch_images.shape[1] * batch_images.shape[2]
        if flat_idx is None:
            flat_idx = torch.randint(0, total_pixels, (ray_batch_size,), generator=generator, device=generator.device)
        flat_idx = torch.as_tensor(flat_idx, device=images.device)
        pixels = batch_images.reshape(-1, 3)[flat_idx]
        return update(grid, batch_poses, flat_idx, pixels, generator, t_rand)

    return step


def _ray_batch_update(intrinsics, render_config, optimizer, apply_diffuse_render_regularization, lr_schedule,
                      mesh=None):
    """The exact update on a drawn ray batch: cast, render both composites,
    L1 losses, backward, Adam. With `mesh`, this rank's share of the rays,
    the losses over the whole batch's count."""

    def update(grid, batch_poses, flat_idx, pixels, generator, t_rand):
        denom = None
        if mesh is not None:
            if t_rand is None:
                # the jitter of the whole batch (the recon composites add no density noise)
                t_rand = draw_ray_randomness(render_config, flat_idx.shape[0], generator, density_noise=False)[0]
            denom = flat_idx.shape[0] * NUM_COLOUR_CHANNELS
            flat_idx, pixels = shard_rays(mesh, flat_idx), shard_rays(mesh, pixels)
            t_rand = None if t_rand is None else shard_rays(mesh, t_rand)
        rays = cast_rays_at_indices(intrinsics, batch_poses, flat_idx)
        optimizer.zero_grad(set_to_none=True)
        out_spec, out_diff = render_specular_and_diffuse(grid, rays, render_config, generator, t_rand)
        total, sums = photometric_losses(
            out_spec.colour, out_diff.colour, pixels, apply_diffuse_render_regularization, denom=denom
        )
        return psnr_metrics(optimizer_step(optimizer, total, sums, lr_schedule, mesh))

    return update


def make_recon_train_step_streaming(
    intrinsics: CameraIntrinsics,
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    apply_diffuse_render_regularization: bool = True,
    lr_schedule=None,
    mesh=None,
) -> Callable:
    """The exact update for a streaming (memmap-backed) dataset: the host
    drew the pixel indices and gathered their [R, 3] pixels; the card casts
    the rays from the step's small pose block, renders, takes the backward
    and runs Adam. Host arrays go over pinned and without blocking, so the
    step adds no host sync. With `mesh` each rank renders its share of them.

    signature: step(grid, batch_poses [B,3,4], flat_idx [R] (into B*H*W),
                    pixels [R,3], generator=None, *, t_rand=None) -> metrics"""
    update = _ray_batch_update(
        intrinsics, render_config, optimizer, apply_diffuse_render_regularization, lr_schedule, mesh
    )

    def step(grid, batch_poses, flat_idx, pixels, generator=None, *, t_rand=None):
        dev = grid.densities.device
        batch_poses, flat_idx, pixels = (_to_device(x, dev) for x in (batch_poses, flat_idx, pixels))
        return update(grid, batch_poses, flat_idx, pixels, generator, t_rand)

    return step


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """A host array or tensor on `dev`; to a card through pinned memory
    without blocking the host."""
    x = torch.as_tensor(x)
    if dev.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(dev, non_blocking=True)
    return x.to(dev)


def make_recon_train_multi_step(
    intrinsics: CameraIntrinsics,
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    ray_batch_size: int,
    num_train_images: int,
    image_batch_size: int,
    steps_per_call: int,
    apply_diffuse_render_regularization: bool = True,
    lr_schedule=None,
    mesh=None,
) -> Callable:
    """K exact ray-batch steps a call. Each step draws its image batch
    ([image_batch_size] of `num_train_images`), its pixel indices and its
    stratified jitter on the device, from `generator` (with `mesh`, every
    rank the same, then its share of the rays).

    signature: multi(grid, images, poses, generator=None, *,
                     batch_indices [K, B]=None, flat_idx [K, R]=None,
                     t_rand [K, R, S]=None) -> last step's metrics
    The keyword arrays replace the draws."""
    step = make_recon_train_step(
        intrinsics, render_config, optimizer, ray_batch_size, apply_diffuse_render_regularization, lr_schedule, mesh
    )

    def multi(grid, images, poses, generator=None, *, batch_indices=None, flat_idx=None, t_rand=None):
        metrics = {}
        for i in range(steps_per_call):
            if batch_indices is None:
                batch = torch.randint(0, num_train_images, (image_batch_size,), generator=generator,
                                      device=generator.device)
            else:
                batch = batch_indices[i]
            metrics = step(grid, images, poses, batch, generator,
                           flat_idx=None if flat_idx is None else flat_idx[i],
                           t_rand=None if t_rand is None else t_rand[i])
        return metrics

    return multi


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
    mesh=None,
) -> Callable:
    """The shear-warp update: one whole base-plane frame per step, L1 in
    base space against the pre-warped target, masked to its coverage. With
    `mesh` each rank renders and compares its share of the base rows,
    divided by the whole frame's coverage.

    signature: step(grid, targets [N,U,V,3], masks [N,U,V], poses [N,3,4],
                    image_idx, generator=None) -> metrics
    `generator` draws the density noise when the config asks for it."""
    base_hw = tuple(base_hw)

    def step(grid, targets, masks, poses, image_idx, generator=None):
        with tracing.span("draw"):  # the drawn view's target, coverage and pose
            image_idx = int(image_idx)
            target, mask, pose_rt = targets[image_idx], masks[image_idx], poses[image_idx]
            pose = CameraPose(rotation=pose_rt[:, :3], translation=pose_rt[:, 3:])
            denom = torch.clamp(mask.sum() * NUM_COLOUR_CHANNELS, min=1.0)
        if mesh is not None:
            target, mask = shard_axis(mesh, target, 0), shard_axis(mesh, mask, 0)
        rows_hw = (mask.shape[0], base_hw[1])
        optimizer.zero_grad(set_to_none=True)
        out, _ = render_shear_warp(
            grid, pose, render_config, base_hw=base_hw, with_diffuse=apply_diffuse_render_regularization,
            generator=generator, mesh=mesh,
        )
        img = out.colour.reshape(*rows_hw, NUM_COLOUR_CHANNELS)
        dimg = out.extra["diffuse_colour"].reshape(*rows_hw, NUM_COLOUR_CHANNELS) if (
            apply_diffuse_render_regularization) else None
        total, sums = photometric_losses(
            img, dimg, target, apply_diffuse_render_regularization, mask=mask[..., None], denom=denom
        )
        return psnr_metrics(optimizer_step(optimizer, total, sums, lr_schedule, mesh))

    return step


def make_recon_train_multi_step_shearwarp(
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    base_hw,
    steps_per_call: int,
    apply_diffuse_render_regularization: bool = True,
    lr_schedule=None,
    mesh=None,
) -> Callable:
    """K shear-warp steps a call, each the single step above on its own
    image (with `mesh`, this rank's base rows). The K image indices are
    drawn on the host (the trainer's numpy Generator), as in the JAX
    trainer.

    signature: multi(grid, targets, masks, poses, image_idxs [K],
                     generator=None) -> last step's metrics"""
    step = make_recon_train_step_shearwarp(
        render_config, optimizer, base_hw, apply_diffuse_render_regularization, lr_schedule, mesh
    )

    def multi(grid, targets, masks, poses, image_idxs, generator=None):
        idxs = [int(i) for i in np.asarray(image_idxs).reshape(-1)]
        if len(idxs) != steps_per_call:
            raise ValueError(f"image_idxs must hold {steps_per_call} indices, got {len(idxs)}")
        metrics = {}
        for idx in idxs:
            with tracing.span("step"):
                metrics = step(grid, targets, masks, poses, idx, generator)
        return metrics

    return multi


def _on(grid: VoxelGrid, dev: torch.device) -> VoxelGrid:
    """The grid's tensors, detached, on `dev`."""
    return grid.replace(densities=grid.densities.detach().to(dev), features=grid.features.detach().to(dev))


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
    `lr_decay_steps_per_stage` updates, then upsamples the grid. A stage runs
    exactly `num_iterations_per_stage` updates, `steps_per_call` a call (the
    last call of a stage takes the rest). Snapshots go to
    `output_dir/saved_models`, ending with `model_final.pth`, with the
    training state in `training_state_latest.pth`; feedback PNGs to
    `output_dir/training_logs/rendered_output` (from `render_feedback_pose`,
    by default the first test, else train, pose); scalars to
    `training_logs/tensorboard` when tensorboardX imports. Summary,
    feedback, test and save run when the global step is a multiple of their
    frequency, on a stage's first call and on its last.

    `resume_from` (a training-state file of either package) fast-forwards the
    grid up the ladder to the saved stage and continues after the saved
    iteration. `coarse_stages_on_cpu` runs every stage but the last on the
    CPU (with `coarse_ray_batch_size` rays when given). A memmap-backed
    (streaming) stage gathers its pixels on the host and trains on the exact
    renderer, one step a call.

    `num_devices > 1` batches the rays data-parallel over that many
    processes of the initialised default group (`maybe_mesh`), one per
    device, every stage but a coarse one on the CPU; the state is
    replicated, and only the process with local rank 0 writes files (the
    others skip the feedback renders and tests, which draw nothing)."""
    del verbose_rendering
    mesh = maybe_mesh(num_devices)
    if mesh is not None:
        log.info(f"data-parallel ray batching over {num_devices} devices")
    writer = is_local_writer()
    output_dir = Path(output_dir)
    model_dir = output_dir / "saved_models"
    logs_dir = output_dir / "training_logs"
    render_dir = logs_dir / "rendered_output"
    tb_writer = None
    if writer:
        for d in (model_dir, logs_dir, render_dir):
            d.mkdir(parents=True, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            tb_writer = SummaryWriter(str(logs_dir / "tensorboard"))
        except ImportError:
            pass
    dev = vol_mod.grid.densities.device

    final_dims = vol_mod.grid.grid_dims
    stagewise_sizes = compute_thre3d_grid_sizes(final_dims, num_stages, scale_factor)
    dataset_config = train_dataset.get_config_dict()
    base_downsample = dataset_config["downsample_factor"]
    stagewise_datasets = [train_dataset]
    for stage in range(1, num_stages):
        cfg = dict(dataset_config)
        cfg["downsample_factor"] = base_downsample * (scale_factor**stage)
        if coarse_stages_on_cpu:
            cfg["device"] = "cpu"
        stagewise_datasets.insert(0, PosedImagesDataset(**cfg))

    # start from scratch at the coarsest stage: uniform random init
    gen = torch.Generator(device=dev).manual_seed(seed)
    grid = scale_voxel_grid(vol_mod.grid, stagewise_sizes[0])
    lo, hi = grid_random_init_range
    grid = grid.replace(
        densities=torch.rand(grid.densities.shape, generator=gen, device=dev) * (hi - lo) + lo,
        features=torch.rand(grid.features.shape, generator=gen, device=dev) * (hi - lo) + lo,
    )
    if mesh is not None:
        replicate(mesh, [grid.densities, grid.features])
    generators = {dev.type: gen}

    if render_feedback_pose is None:
        pose0 = (test_dataset if test_dataset is not None else train_dataset).poses[0]
        render_feedback_pose = CameraPose(rotation=pose0[:, :3], translation=pose0[:, 3:])
    camera_intrinsics = train_dataset.camera_intrinsics
    extra_info = {
        CAMERA_BOUNDS: list(train_dataset.camera_bounds),
        CAMERA_INTRINSICS: list(camera_intrinsics),
        HEMISPHERICAL_RADIUS: train_dataset.get_hemispherical_radius_estimate(),
    }
    if not fast_debug_mode and writer:
        from voxe_tpu_torch.viz.static import visualize_camera_rays

        log.info("creating a camera-rays visualization ...")
        visualize_camera_rays(train_dataset, output_dir, num_rays_per_image=1)
    rng = np.random.default_rng(seed)
    log.info("beginning reconstruction training")
    time_training = 0.0
    global_step = 0
    resume_meta = None
    if resume_from is not None:
        _, resume_meta = read_training_state(resume_from)
        log.info(f"resuming from {resume_from}: stage {resume_meta['stage']}, "
                 f"stage_iteration {resume_meta['stage_iteration']}")
        global_step = int(resume_meta["global_step"])

    for stage in range(1, num_stages + 1):
        if resume_meta is not None and stage < resume_meta["stage"]:
            # fast-forward a finished stage: the grid follows the ladder
            if stage != num_stages:
                with torch.no_grad():
                    grid = scale_voxel_grid(grid, stagewise_sizes[stage])
            continue
        on_cpu = coarse_stages_on_cpu and stage != num_stages
        stage_dev = torch.device("cpu") if on_cpu else dev
        stage_mesh = None if on_cpu else mesh  # a coarse stage on the CPU runs unsharded on every rank, as in JAX
        if on_cpu:
            log.info(f"stage {stage} runs on the CPU (coarse_stages_on_cpu)")
        grid = _on(grid, stage_dev)
        stage_gen = generators.setdefault(stage_dev.type, torch.Generator(device=stage_dev).manual_seed(seed))
        stage_dataset = stagewise_datasets[stage - 1]
        intr = stage_dataset.camera_intrinsics
        streaming = stage_dataset.streaming  # its steps gather pixels and poses on the host
        images, poses = (None, None) if streaming else stage_dataset.device_arrays()
        batch_iter = stage_dataset.iter_batches(image_batch_cache_size, rng)
        stage_lr = learning_rate * (stagewise_lr_decay_gamma ** (stage - 1))
        schedule = exponential_decay_staircase(stage_lr, lr_decay_steps_per_stage, lr_decay_gamma_per_stage)
        optimizer = make_adam(grid, stage_lr)
        render_config = vol_mod.render_config
        effective_ray_batch = ray_batch_size
        if on_cpu and coarse_ray_batch_size is not None:
            effective_ray_batch = coarse_ray_batch_size
        stage_ray_batch = min(effective_ray_batch, image_batch_cache_size * intr.height * intr.width)
        sw_active = use_shear_warp and not streaming
        if use_shear_warp and streaming:
            log.warning("shear-warp training needs the base targets on the device; "
                        "the streaming stage falls back to the exact renderer")
        if sw_active:
            base_res = shear_warp_base_res or lane_aligned_res(2 * max(intr.height, intr.width))
            base_hw = (base_res, base_res)
            log.info(f"shear-warp path: base lattice {base_hw}")
            sw_targets, sw_masks = warp_dataset_to_base(images, poses, intr, grid, base_hw)
            train_step = make_recon_train_step_shearwarp(
                render_config, optimizer, base_hw, apply_diffuse_render_regularization, lr_schedule=schedule,
                mesh=stage_mesh,
            )

            def build(k):  # called within this stage only
                return make_recon_train_multi_step_shearwarp(
                    render_config, optimizer, base_hw, k, apply_diffuse_render_regularization, lr_schedule=schedule,
                    mesh=stage_mesh,
                )
        elif streaming:
            if steps_per_call > 1:
                log.warning("streaming dataset: K steps a call need the scene on the device; "
                            "falling back to steps_per_call=1")
                steps_per_call = 1
            train_step = make_recon_train_step_streaming(
                intr, render_config, optimizer, apply_diffuse_render_regularization, lr_schedule=schedule,
                mesh=stage_mesh,
            )
        else:
            def build(k):  # called within this stage only
                n = len(stage_dataset)
                return make_recon_train_multi_step(
                    intr, render_config, optimizer, stage_ray_batch, n, min(image_batch_cache_size, n), k,
                    apply_diffuse_render_regularization, lr_schedule=schedule, mesh=stage_mesh,
                )

            train_step = make_recon_train_step(
                intr, render_config, optimizer, stage_ray_batch, apply_diffuse_render_regularization,
                lr_schedule=schedule, mesh=stage_mesh,
            )
        multi_steps = {}

        start_iteration = 1
        if resume_meta is not None and stage == resume_meta["stage"]:
            load_training_state(resume_from, grid, optimizer, stage_gen)
            start_iteration = int(resume_meta["stage_iteration"]) + 1
            resume_meta = None
        log.info(
            f"training stage: {stage}  grid: {grid.grid_dims}  images: [{intr.height} x {intr.width}]  "
            f"lr: {stage_lr:.5f}"
        )
        stage_time_start, stage_wall_start = time_training, time.perf_counter()
        feedback_s = test_s = 0.0
        last_time = time.perf_counter()
        for stage_iteration in range(start_iteration, num_iterations_per_stage + 1, steps_per_call):
            # the last call of a stage may be partial: exactly num_iterations_per_stage updates
            chunk = min(steps_per_call, num_iterations_per_stage - stage_iteration + 1)
            if steps_per_call > 1 and chunk not in multi_steps:
                multi_steps[chunk] = build(chunk)
            if sw_active:
                if steps_per_call > 1:
                    idxs = rng.integers(0, len(stage_dataset), chunk)
                    metrics = multi_steps[chunk](grid, sw_targets, sw_masks, poses, idxs, stage_gen)
                else:
                    idx = int(rng.integers(0, len(stage_dataset)))
                    metrics = train_step(grid, sw_targets, sw_masks, poses, idx, stage_gen)
            elif streaming:
                # pixels gathered on the host from the memmap; the card sees
                # the small pose block and the [R, 3] pixel batch
                batch_indices = np.asarray(next(batch_iter))
                frame_pixels = intr.height * intr.width
                flat_idx = rng.integers(0, len(batch_indices) * frame_pixels, stage_ray_batch)
                pixels = stage_dataset.sample_pixels(flat_idx % frame_pixels, batch_indices[flat_idx // frame_pixels])
                metrics = train_step(grid, stage_dataset.poses[batch_indices], flat_idx, pixels, stage_gen)
            elif steps_per_call > 1:
                metrics = multi_steps[chunk](grid, images, poses, stage_gen)
            else:
                metrics = train_step(grid, images, poses, next(batch_iter), stage_gen)
            global_step += chunk
            last_iter = stage_iteration + steps_per_call > num_iterations_per_stage
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
            if (global_step % feedback_freq == 0 or stage_iteration == 1 or last_iter) and not fast_debug_mode and (
                    writer):
                from voxe_tpu_torch.viz.static import visualize_sh_vox_grid_vol_mod_rendered_feedback

                t0 = time.perf_counter()
                visualize_sh_vox_grid_vol_mod_rendered_feedback(
                    VolumetricModel(grid, render_config), "default", render_feedback_pose, camera_intrinsics,
                    global_step, render_dir, training_time=time_training, use_shear_warp=sw_active,
                )
                last_time = time.perf_counter()
                feedback_s += last_time - t0
            if test_dataset is not None and not fast_debug_mode and writer and (
                    global_step % test_freq == 0 or last_iter):
                from voxe_tpu_torch.train.testers import test_sh_vox_grid_vol_mod_with_posed_images

                t0 = time.perf_counter()
                test_sh_vox_grid_vol_mod_with_posed_images(
                    VolumetricModel(_on(grid, dev), render_config), test_dataset, tb_writer, global_step
                )
                last_time = time.perf_counter()
                test_s += last_time - t0
            if (global_step % save_freq == 0 or stage_iteration == 1 or last_iter) and writer:
                VolumetricModel(_on(grid, grid.densities.device), render_config).save(
                    model_dir / f"model_stage_{stage}_iter_{global_step}.pth", extra_info=extra_info
                )
                save_training_state(
                    model_dir / "training_state_latest.pth",
                    training_state_arrays(grid, optimizer, stage_gen, global_step),
                    {"stage": stage, "stage_iteration": stage_iteration, "global_step": global_step},
                )
        if stage_dev.type == "cuda":
            torch.cuda.synchronize(stage_dev)
        time_training += time.perf_counter() - last_time
        stage_s = time_training - stage_time_start
        log.info(
            f"stage {stage} done: training time {stage_s:.1f}s (synced), wall "
            f"{time.perf_counter() - stage_wall_start:.1f}s incl. feedback {feedback_s:.1f}s, "
            f"test {test_s:.1f}s, logging and checkpoints",
            extra={"stage": stage, "stage_training_s": stage_s, "stage_feedback_s": feedback_s,
                   "stage_test_s": test_s, "stage_device": stage_dev.type},
        )
        if stage != num_stages:
            with torch.no_grad():
                grid = scale_voxel_grid(grid, stagewise_sizes[stage])

    vol_mod.grid = _on(grid, dev)
    vol_mod.extra_info.update(extra_info)
    if writer:
        vol_mod.save(model_dir / "model_final.pth", extra_info=extra_info)
    if tb_writer is not None:
        tb_writer.close()
    log.info(f"Training complete; actual training time: {timedelta(seconds=time_training)}",
             extra={"time_training": time_training})
    return vol_mod

"""SDS edit trainer (counterpart of voxe_tpu/train/sds.py).

One step renders the grid, takes the SDS loss through VAE encode and the CFG
UNet, the volumetric regularizers (density correlation, or the masked
photometric loss of uncoupled mode; feature correlation; TV), runs the
backward and one Adam update of the grid in place (`torch.optim.Adam`,
optax.adam's update). The step kinds:

- `make_sds_train_step_shearwarp`: one hemisphere pose, the base-plane
  frame of the shear-warp render, oriented upright for SD;
- `make_sds_train_step_shearwarp_data`: B dataset poses a step, their frames
  stacked into one SD batch, with uncoupled mode's masked L1/L2 against
  targets pre-warped onto each pose's base lattice;
- `make_sds_train_step`: the exact renderer on cast rays (one or more full
  frames), for `use_shear_warp=False`;
- `make_sds_train_multi_step`: K random-pose steps per call, pose,
  direction bucket and t drawn from a `torch.Generator`.

There is no jit: the JAX `lax.scan` over K steps is a Python loop, and the
random draws come from a `torch.Generator` (tests may inject them).
`train_sh_vox_grid_vol_mod_with_posed_images_and_sds` is the editing loop:
host pose draws from a numpy Generator (the same sequence as the JAX loop
for the same seed), the t schedule, direction-keyed text embeddings, the
staircase lr, feedback renders and checkpoints.
"""
from __future__ import annotations

import time
from datetime import timedelta
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.grid.voxels import VoxelGrid
from voxe_tpu_torch.models.sd.sds import DIRECTION_PROMPTS, StableDiffusion, scoreDistillationLoss
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig, render_sh_voxel_grid
from voxe_tpu_torch.render.rays import Rays, cast_rays, flatten_rays
from voxe_tpu_torch.render.shearwarp import (
    check_shear_warp_hemisphere,
    check_shear_warp_poses,
    lane_aligned_res,
    orient_base_image,
    render_shear_warp,
)
from voxe_tpu_torch.train.losses import (
    density_correlation_loss_fn,
    feature_correlation_loss,
    l1_loss,
    l2_loss,
    tv_loss_on_grid,
)
from voxe_tpu_torch.train.recon import (
    exponential_decay_staircase,
    make_adam,
    optimizer_step,
    warp_dataset_to_base,
)
from voxe_tpu_torch.utils.camera import CameraPose, direction_index, get_random_pose, random_pose
from voxe_tpu_torch.utils.constants import CAMERA_BOUNDS, CAMERA_INTRINSICS, HEMISPHERICAL_RADIUS
from voxe_tpu_torch.utils.logging import log

DIR_TO_NUM_DICT = {"side": 0, "overhead": 1, "back": 2, "front": 3}
HEMISPHERICAL_RADIUS_CONSTANT = 4.0311  # reference sds_trainer.py:45


def _pitch_yaw_from_Rt(pose_rt: np.ndarray):
    """(reference sds_trainer.py:536-541)"""
    tx, ty, tz = pose_rt[:, -1]
    tr = np.sqrt(tx**2 + ty**2)
    pitch = np.arctan2(tz, tr) * 180 / np.pi
    yaw = np.arccos(np.clip(pose_rt[0, 0], -1.0, 1.0)) * 180.0 / np.pi
    return pitch, yaw


def get_dir_batch_from_poses(poses: np.ndarray):
    """View direction of each dataset pose [N, 3, 4] (reference
    sds_trainer.py:543-561)."""
    dir_batch = []
    for i in range(poses.shape[0]):
        pitch, yaw = _pitch_yaw_from_Rt(poses[i])
        direction = "front"
        if yaw > 45.0:
            direction = "side"
        if yaw > 120.0:
            direction = "back"
        if pitch > 55.0:
            direction = "overhead"
        dir_batch.append(direction)
    return dir_batch


def _regularize(
    grid: VoxelGrid,
    ref_densities,
    ref_features,
    total,
    metrics: dict,
    *,
    photometric=None,
    density_correlation_weight: float = 0.0,
    feature_correlation_weight: float = 0.0,
    tv_density_weight: float = 0.0,
    tv_features_weight: float = 0.0,
    l2_mode: bool = False,
    l1_mode: bool = False,
):
    """Add the volumetric terms to `total`: the photometric loss (uncoupled
    mode) or density and feature correlation, then TV. The photometric loss
    takes the density-correlation weight, as in the reference."""
    if photometric is not None:
        total = total + photometric * density_correlation_weight
        metrics["specular_loss"] = photometric.detach()
    else:
        dcl, _ = density_correlation_loss_fn(grid.densities, ref_densities, l2_mode=l2_mode, l1_mode=l1_mode)
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
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    vae_eps: Optional[torch.Tensor] = None,
    **weights,
):
    """The random-pose shear-warp step's loss (the JAX `loss_fn`): (total,
    metrics). `weights`: the `_regularize` weights and modes."""
    total = torch.zeros((), device=grid.densities.device)
    if do_sds:
        out, _ = render_shear_warp(
            grid, CameraPose(rotation, translation.reshape(3, 1)), render_config, base_hw=base_hw,
            generator=generator,
        )
        # upright frame for SD (rows down camera -up, cols along right)
        imgs = orient_base_image(out.colour.reshape(*base_hw, 3), rotation)[None]
        total = total + sd.sds_loss(
            text_embeddings, imgs, t, guidance_scale, generator=generator, noise=noise, vae_eps=vae_eps
        )
    return _regularize(grid, ref_densities, ref_features, total, {}, **weights)


def make_sds_train_step_shearwarp(
    sd: StableDiffusion,
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    base_hw: tuple,
    lr_schedule=None,
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
        return optimizer_step(optimizer, total, metrics, lr_schedule)

    return step


def make_sds_train_step_shearwarp_data(
    sd: StableDiffusion,
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    base_hw: tuple,
    num_frames: int,
    *,
    do_sds: bool = True,
    guidance_scale: float = 100.0,
    uncoupled_mode: bool = False,
    uncoupled_l2_mode: bool = False,
    lr_schedule=None,
    **weights,
) -> Callable:
    """The shear-warp edit step for dataset poses (data-pose and uncoupled
    modes): `num_frames` poses rendered and stacked into one SD batch;
    uncoupled mode adds the masked L1 (or L2) against the base-plane
    targets, averaged over the frames.

    signature: step(grid, text_embeddings, rotations [B,3,3],
                    translations [B,3,1], base_pixels [B,U,V,3],
                    base_masks [B,U,V], ref_densities, ref_features, t,
                    *, generator=None, noise=None, vae_eps=None) -> metrics"""
    base_hw = tuple(base_hw)

    def step(
        grid, text_embeddings, rotations, translations, base_pixels, base_masks,
        ref_densities, ref_features, t, *, generator=None, noise=None, vae_eps=None,
    ):
        optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=grid.densities.device)
        frames, photometric = [], torch.zeros((), device=grid.densities.device)
        for i in range(num_frames):
            out, _ = render_shear_warp(
                grid, CameraPose(rotations[i], translations[i]), render_config, base_hw=base_hw,
                generator=generator,
            )
            img = out.colour.reshape(*base_hw, 3)
            if uncoupled_mode:
                m = base_masks[i][..., None]
                denom = torch.clamp(base_masks[i].sum() * 3.0, min=1.0)
                diff = img - base_pixels[i]
                err = diff**2 if uncoupled_l2_mode else torch.abs(diff)
                photometric = photometric + (err * m).sum() / denom
            frames.append(orient_base_image(img, rotations[i]))
        if do_sds:
            imgs = torch.stack(frames)
            total = total + sd.sds_loss(
                text_embeddings, imgs, t, guidance_scale, generator=generator, noise=noise, vae_eps=vae_eps
            )
        total, metrics = _regularize(
            grid, ref_densities, ref_features, total, {},
            photometric=photometric / num_frames if uncoupled_mode else None, **weights,
        )
        return optimizer_step(optimizer, total, metrics, lr_schedule)

    return step


def make_sds_train_step(
    sd: StableDiffusion,
    render_config: SHVoxGridRenderConfig,
    optimizer: torch.optim.Optimizer,
    image_dims: tuple,
    *,
    do_sds: bool = True,
    guidance_scale: float = 100.0,
    uncoupled_mode: bool = False,
    uncoupled_l2_mode: bool = False,
    lr_schedule=None,
    **weights,
) -> Callable:
    """The edit step on the exact renderer: flat rays of one or more full
    frames, jittered sampling, SD on the frames; uncoupled mode's L1 (or
    L2) against `pixels`.

    signature: step(grid, text_embeddings, rays (flat), pixels [R, 3],
                    ref_densities, ref_features, t, *, generator=None,
                    t_rand=None, noise=None, vae_eps=None) -> metrics
    `t_rand` ([R, S]) replaces the sampling jitter drawn from `generator`."""
    im_h, im_w = image_dims

    def step(
        grid, text_embeddings, rays, pixels, ref_densities, ref_features, t,
        *, generator=None, t_rand=None, noise=None, vae_eps=None,
    ):
        optimizer.zero_grad(set_to_none=True)
        colours = render_sh_voxel_grid(grid, rays, render_config, generator=generator, t_rand=t_rand).colour
        total = torch.zeros((), device=grid.densities.device)
        if do_sds:
            imgs = colours.reshape(-1, im_h, im_w, 3)
            total = total + sd.sds_loss(
                text_embeddings, imgs, t, guidance_scale, generator=generator, noise=noise, vae_eps=vae_eps
            )
        photometric = None
        if uncoupled_mode:
            photometric = l2_loss(colours, pixels) if uncoupled_l2_mode else l1_loss(colours, pixels)
        total, metrics = _regularize(grid, ref_densities, ref_features, total, {}, photometric=photometric, **weights)
        return optimizer_step(optimizer, total, metrics, lr_schedule)

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
    lr_schedule=None,
    **loss_kwargs,
) -> Callable:
    """K SDS edit steps per call (random-pose mode): each step draws a
    hemisphere pose, buckets its view direction to pick the text
    embeddings, draws t in [t_lo, t_hi], and takes one edit step on the
    shear-warp path or, without `use_shear_warp`, on the exact renderer.

    signature: multi_step(grid, text_embeddings_by_dir [4, 2, 77, D],
                          ref_densities, ref_features, t_bounds [K, 2],
                          generator) -> last step's metrics
    """
    im_h, im_w = intrinsics.height, intrinsics.width
    if use_shear_warp:
        base_hw = tuple(sw_base_hw) if sw_base_hw is not None else (im_h, im_w)
        step = make_sds_train_step_shearwarp(sd, render_config, optimizer, base_hw, lr_schedule, **loss_kwargs)
    else:
        step = make_sds_train_step(sd, render_config, optimizer, (im_h, im_w), lr_schedule=lr_schedule, **loss_kwargs)

    def multi_step(grid, text_by_dir, ref_densities, ref_features, t_bounds, generator):
        t_bounds = torch.as_tensor(t_bounds).cpu()
        if t_bounds.shape != (steps_per_call, 2):
            raise ValueError(f"t_bounds must be [{steps_per_call}, 2], got {tuple(t_bounds.shape)}")
        dev = grid.densities.device
        metrics = {}
        for i in range(steps_per_call):
            rotation, translation, pitch_deg, yaw_deg = random_pose(generator, radius, device=dev)
            dir_idx = direction_index(float(pitch_deg), float(yaw_deg))
            t_lo, t_hi = int(t_bounds[i, 0]), int(t_bounds[i, 1])
            t = int(torch.randint(t_lo, t_hi + 1, (), generator=generator, device=generator.device))
            if use_shear_warp:
                metrics = step(
                    grid, text_by_dir[dir_idx], rotation, translation,
                    ref_densities, ref_features, t, generator=generator,
                )
            else:
                rays = flatten_rays(cast_rays(intrinsics, rotation, translation))
                pixels = torch.zeros((im_h * im_w, 3), device=dev)
                metrics = step(
                    grid, text_by_dir[dir_idx], rays, pixels, ref_densities, ref_features, t, generator=generator,
                )
            metrics["dir_idx"] = dir_idx
            metrics["t"] = t
        return metrics

    return multi_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_sh_vox_grid_vol_mod_with_posed_images_and_sds(
    sds_vol_mod: VolumetricModel,
    pretrained_vol_mod: VolumetricModel,
    train_dataset: PosedImagesDataset,
    image_dims: tuple,
    output_dir: Path,
    *,
    ray_batch_size: int = 84672,
    num_iterations: int = 8000,
    scale_factor: float = 2.0,
    learning_rate: float = 0.03,
    lr_decay_start: int = 5000,
    lr_freq: int = 400,
    lr_gamma: float = 0.8,
    render_feedback_pose: Optional[CameraPose] = None,
    save_freq: int = 1000,
    feedback_freq: int = 100,
    summary_freq: int = 10,
    apply_diffuse_render_regularization: bool = True,
    verbose_rendering: bool = True,
    sds_prompt: str = "none",
    new_frame_frequency: int = 1,
    density_correlation_weight: float = 0.0,
    feature_correlation_weight: float = 0.0,
    tv_density_weight: float = 0.0,
    tv_features_weight: float = 0.0,
    do_sds: bool = True,
    sds_t_freq: int = 200,
    sds_t_start: int = 1500,
    sds_t_gamma: float = 1.0,
    uncoupled_mode: bool = False,
    data_pose_mode: bool = False,
    uncoupled_l2_mode: bool = False,
    l2_mode: bool = False,
    l1_mode: bool = False,
    sd_model: Optional[StableDiffusion] = None,
    sd_version: str = "2.0",
    sd_weights_dir: Optional[Path] = None,
    seed: int = 42,
    fast_debug_mode: bool = False,
    steps_per_call: int = 1,
    use_shear_warp: bool = True,
    shear_warp_base_res: Optional[int] = None,
) -> VolumetricModel:
    """The Vox-E editing loop on the grid's device (reference
    sds_trainer.py:47-469).

    Random hemisphere poses, or with `data_pose_mode` / `uncoupled_mode`
    batches of dataset poses; the shear-warp render by default (dataset
    poses through `make_sds_train_step_shearwarp_data` with targets
    pre-warped onto the base lattice), the exact renderer with
    `use_shear_warp=False`. `shear_warp_base_res` is the side of the square
    base lattice fed to SD (default `lane_aligned_res(max(H, W))`).
    `steps_per_call > 1` keeps the JAX fused branch's batch choice and its
    summary / feedback / save cadence (`step % freq < steps_per_call`);
    random poses then come from `make_sds_train_multi_step`. Snapshots go to
    `output_dir/saved_models` (`model_iter_{n}.pth`, `model_final.pth`),
    feedback PNGs to `output_dir/training_logs/rendered_output`."""
    if sds_prompt == "none":
        raise ValueError("you have to supply a text prompt to use SDS")
    del scale_factor, verbose_rendering
    im_h, im_w = image_dims
    output_dir = Path(output_dir)
    grid = sds_vol_mod.grid
    dev = grid.densities.device
    render_config = sds_vol_mod.render_config

    # frozen reference grids for the volumetric regularizers
    ref_densities = pretrained_vol_mod.grid.densities.detach().to(dev)
    ref_features = pretrained_vol_mod.grid.features.detach().to(dev)

    sds_loss_wrapper = scoreDistillationLoss(
        sds_prompt, sd_model=sd_model, t_sched_start=sds_t_start, t_sched_freq=sds_t_freq,
        t_sched_gamma=sds_t_gamma, sd_version=sd_version, weights_dir=sd_weights_dir, device=dev,
    )
    sd = sds_loss_wrapper.sd_model

    camera_intrinsics = train_dataset.camera_intrinsics
    extra_info = {
        CAMERA_BOUNDS: list(train_dataset.camera_bounds),
        CAMERA_INTRINSICS: list(camera_intrinsics),
        HEMISPHERICAL_RADIUS: train_dataset.get_hemispherical_radius_estimate(),
    }
    model_dir = output_dir / "saved_models"
    render_dir = output_dir / "training_logs" / "rendered_output"
    for d in (model_dir, render_dir):
        d.mkdir(parents=True, exist_ok=True)

    schedule = exponential_decay_staircase(learning_rate, lr_freq, lr_gamma, transition_begin=lr_decay_start)
    optimizer = make_adam(grid, learning_rate)

    data_mode = uncoupled_mode or data_pose_mode
    sw_data_mode = use_shear_warp and data_mode
    base_res = shear_warp_base_res or lane_aligned_res(max(im_h, im_w))
    base_hw = (base_res, base_res)
    if use_shear_warp:
        log.info(f"shear-warp path: base lattice {base_hw}")
        # the render clamps an eye inside the volume and draws wrong frames:
        # check the pose source once, before training
        if data_mode:
            check_shear_warp_poses(grid, np.asarray(train_dataset.poses), "SDS edit (dataset poses)")
        else:
            check_shear_warp_hemisphere(grid, HEMISPHERICAL_RADIUS_CONSTANT, "SDS edit (hemisphere poses)")
    directional = sds_loss_wrapper.directional
    fused_random = steps_per_call > 1 and not data_mode and directional
    fused_data = steps_per_call > 1 and sw_data_mode and directional
    cadence = steps_per_call if (fused_random or fused_data) else 1
    batch_size_in_images = max(1, int(ray_batch_size / (im_h * im_w)))
    if data_mode:  # iter_batches clamps to the dataset size
        batch_size_in_images = min(batch_size_in_images, len(train_dataset))

    weights = dict(
        density_correlation_weight=density_correlation_weight,
        feature_correlation_weight=feature_correlation_weight,
        tv_density_weight=tv_density_weight, tv_features_weight=tv_features_weight,
        l2_mode=l2_mode, l1_mode=l1_mode,
    )
    modes = dict(uncoupled_mode=uncoupled_mode, uncoupled_l2_mode=uncoupled_l2_mode)
    if fused_random:
        def multi_step_fn(k: int):  # K steps a call; the last call may be shorter
            return make_sds_train_multi_step(
                sd, render_config, optimizer, camera_intrinsics, k, use_shear_warp=use_shear_warp,
                sw_base_hw=base_hw, lr_schedule=schedule, do_sds=do_sds, **weights,
            )

        text_by_dir = sds_loss_wrapper.stacked_encodings()
    elif sw_data_mode:
        step_fn = make_sds_train_step_shearwarp_data(
            sd, render_config, optimizer, base_hw, batch_size_in_images,
            do_sds=do_sds, lr_schedule=schedule, **modes, **weights,
        )
    elif use_shear_warp:
        step_fn = make_sds_train_step_shearwarp(
            sd, render_config, optimizer, base_hw, schedule, do_sds=do_sds, **weights
        )
    else:
        step_fn = make_sds_train_step(
            sd, render_config, optimizer, image_dims, do_sds=do_sds, lr_schedule=schedule, **modes, **weights
        )

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if data_mode:
        batch_iter = train_dataset.iter_batches(batch_size_in_images, rng)
        images, poses_t = train_dataset.device_arrays()
        poses_t = poses_t.to(dev)
        if sw_data_mode:
            if uncoupled_mode:  # every target splatted onto its pose's base lattice, once
                base_targets, base_masks = warp_dataset_to_base(
                    images.to(dev), poses_t, camera_intrinsics, grid, base_hw
                )
            zero_pix = torch.zeros((batch_size_in_images, *base_hw, 3), device=dev)
            zero_msk = torch.zeros((batch_size_in_images, *base_hw), device=dev)
        else:
            images = images.to(dev)

    log.info(f"beginning SDS edit training: grid {grid.grid_dims}, frame [{im_h} x {im_w}], prompt: '{sds_prompt}'")
    time_training = 0.0
    direction, current_pose = "front", None

    def frozen() -> VolumetricModel:
        return VolumetricModel(
            grid.replace(densities=grid.densities.detach(), features=grid.features.detach()), render_config
        )

    def report(global_step: int, chunk_start: int, metrics: dict) -> None:
        last_iter = global_step >= num_iterations
        first = chunk_start == 1
        due = (lambda freq: global_step % freq < cadence) if cadence > 1 else (lambda freq: global_step % freq == 0)
        if due(summary_freq) or first or last_iter:
            metrics_host = {k: float(v) for k, v in metrics.items() if k != "dir_idx"}
            log.info(
                f"Iteration: {global_step} " + " ".join(f"{k}: {v:.4f}" for k, v in metrics_host.items())
                + f" dir: {direction} max_t: {sd.get_max_step_ratio():.3f}"
            )
        if (due(feedback_freq) or first or last_iter) and not fast_debug_mode:
            from voxe_tpu_torch.viz.static import visualize_sh_vox_grid_vol_mod_rendered_feedback

            if render_feedback_pose is not None:
                feedback_pose = render_feedback_pose
            elif fused_random:  # the poses were drawn in the multi-step: draw one here
                feedback_pose = get_random_pose(HEMISPHERICAL_RADIUS_CONSTANT, rng)[0]
            else:
                feedback_pose = current_pose
            visualize_sh_vox_grid_vol_mod_rendered_feedback(
                frozen(), "sds", feedback_pose, camera_intrinsics, global_step, render_dir,
                training_time=time_training, log_diffuse_rendered_version=apply_diffuse_render_regularization,
                overridden_num_samples_per_ray=render_config.render_num_samples_per_ray,
                use_shear_warp=use_shear_warp,
            )
        # the fused branch saves at its cadence and at the end only
        if due(save_freq) or (first and cadence == 1) or last_iter:
            frozen().save(model_dir / f"model_iter_{global_step}.pth", extra_info=extra_info)

    def new_frame():
        """Draw the next pose (or dataset batch); returns the step's
        pose-dependent arguments."""
        nonlocal direction, current_pose
        if data_mode:
            batch_idx = np.asarray(next(batch_iter))
            poses = train_dataset.poses[batch_idx]
            direction = get_dir_batch_from_poses(poses)[0]
            current_pose = CameraPose(rotation=poses[0][:, :3], translation=poses[0][:, 3:])
            idx = torch.as_tensor(batch_idx, device=dev)
            if sw_data_mode:
                pix, msk = (base_targets[idx], base_masks[idx]) if uncoupled_mode else (zero_pix, zero_msk)
                return (poses_t[idx, :, :3], poses_t[idx, :, 3:], pix, msk)
            rays = [flatten_rays(cast_rays(camera_intrinsics, p[:, :3], p[:, 3:], device=dev)) for p in poses]
            rays = Rays(torch.cat([r.origins for r in rays]), torch.cat([r.directions for r in rays]))
            return (rays, images[idx].reshape(-1, 3))
        pose, direction, _, _ = get_random_pose(HEMISPHERICAL_RADIUS_CONSTANT, rng)
        current_pose = pose
        rot = torch.as_tensor(pose.rotation, device=dev)
        trans = torch.as_tensor(pose.translation, device=dev).reshape(3, 1)
        if use_shear_warp:
            return (rot, trans)
        rays = flatten_rays(cast_rays(camera_intrinsics, rot, trans))
        return (rays, torch.zeros((im_h * im_w, 3), device=dev))

    if fused_random:
        for chunk_start in range(1, num_iterations + 1, steps_per_call):
            chunk = min(steps_per_call, num_iterations - chunk_start + 1)
            last_time = time.perf_counter()
            bounds = []
            for gs in range(chunk_start, chunk_start + chunk):
                sd.update_t_schedule(gs)
                bounds.append(sd.t_bounds())
            metrics = multi_step_fn(chunk)(grid, text_by_dir, ref_densities, ref_features, bounds, gen)
            direction = DIRECTION_PROMPTS[metrics["dir_idx"]]
            _sync(dev)
            time_training += time.perf_counter() - last_time
            report(chunk_start + chunk - 1, chunk_start, metrics)
    else:
        pose_args = None
        chunk_start = 1
        for global_step in range(1, num_iterations + 1):
            last_time = time.perf_counter()
            if global_step % new_frame_frequency == 0 or global_step == 1:
                pose_args = new_frame()
            sd.update_t_schedule(global_step)
            t = sd.sample_timestep(gen)
            text_embeddings = sds_loss_wrapper.encoding_for_direction(direction)
            metrics = step_fn(grid, text_embeddings, *pose_args, ref_densities, ref_features, t, generator=gen)
            _sync(dev)
            time_training += time.perf_counter() - last_time
            # the fused data branch reports once per chunk of steps_per_call
            if global_step % cadence == 0 or global_step == num_iterations:
                report(global_step, chunk_start, metrics)
                chunk_start = global_step + 1

    sds_vol_mod.grid = frozen().grid
    sds_vol_mod.extra_info.update(extra_info)
    sds_vol_mod.save(model_dir / "model_final.pth", extra_info=extra_info)
    log.info(
        f"Edit training complete; actual training time: {timedelta(seconds=time_training)}",
        extra={"time_training": time_training, "num_iterations": num_iterations},
    )
    return sds_vol_mod

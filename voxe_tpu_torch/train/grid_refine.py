"""The legacy iterate-and-refine loop (counterpart of
voxe_tpu/train/grid_refine.py, the reference's `modules/grid_refine.py`,
which the reference imports nowhere).

What it does, as the JAX package does it:
- a stagewise loop over DATASET poses (a random image batch a step, the
  last image's pose), with the legacy direction buckets (yaw > 60 side);
- a graph cut of the edit / object attention grids and a voxel merge of the
  reference model's densities and features into the SDS model's non-edit
  voxels at iteration 1 and every `refine_freq`, during the loop, each
  followed by a feedback render of the refined model;
- with `relearn_attn_grids` (off by default, as the reference hard-codes
  it): each iteration renders a no-grad RGB frame of the edit model on the
  shear-warp base lattice, takes SD's cross-attention maps of the edit and
  object tokens as targets and updates both attention grids with the
  two-channel shear-warp dual update (masked L1 + TV, two Adams on the
  staircase learning rate, fresh each stage);
- between stages all four models scale together (the JAX package's
  documented divergence from the reference, which scales only the edit one);
- snapshots under the legacy names `model_edit_stage_{s}_iter_{g}.pth` and
  `model_pbject_stage_{s}_iter_{g}.pth` (the reference's typo), and the
  final `model_final_{edit,object,sds}.pth`.

JAX's `jax.random` draws (the SD pass's t, VAE eps and noise, the density
noise) come from a `torch.Generator` seeded with `seed` on the grids'
device; the image batches from the same numpy generator as in JAX.
"""
from __future__ import annotations

import time
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.grid.voxels import scale_voxel_grid
from voxe_tpu_torch.models.sd.sds import StableDiffusion
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.seg.graphcut import get_edit_region, merge_edit_region
from voxe_tpu_torch.train.recon import exponential_decay_staircase
from voxe_tpu_torch.train.refine import make_attn_adam, make_dual_attn_update
from voxe_tpu_torch.train.sds import DIR_TO_NUM_DICT, _sync
from voxe_tpu_torch.utils.camera import CameraPose
from voxe_tpu_torch.utils.constants import CAMERA_BOUNDS, CAMERA_INTRINSICS, HEMISPHERICAL_RADIUS
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.misc import compute_thre3d_grid_sizes


def _legacy_pitch_yaw_from_Rt(pose_rt: np.ndarray):
    """(pitch, yaw) in degrees of a [3, 4] camera-to-world pose."""
    tx, ty, tz = pose_rt[:, -1]
    tr = np.sqrt(tx**2 + ty**2)
    pitch = np.arctan2(tz, tr) * 180.0 / np.pi
    yaw = np.arccos(np.clip(pose_rt[0, 0], -1.0, 1.0)) * 180.0 / np.pi
    return pitch, yaw


def get_dir_batch_from_poses_legacy(poses: np.ndarray):
    """The legacy view-direction buckets: side above 60 degrees of yaw (the
    live SDS trainer's is 45), back above 120, overhead above 55 of pitch."""
    dir_batch = []
    for i in range(poses.shape[0]):
        pitch, yaw = _legacy_pitch_yaw_from_Rt(poses[i])
        direction = "front"
        if yaw > 60.0:
            direction = "side"
        if yaw > 120.0:
            direction = "back"
        if pitch > 55.0:
            direction = "overhead"
        dir_batch.append(direction)
    return dir_batch


def _scale_all(models, size) -> None:
    for vm in models:
        vm.grid = scale_voxel_grid(vm.grid, size, include_attn=vm.grid.attn is not None)


def refine_model(
    vol_mod_sds: VolumetricModel,
    vol_mod_edit: VolumetricModel,
    vol_mod_object: VolumetricModel,
    vol_mod_ref: VolumetricModel,
    train_dataset: PosedImagesDataset,
    output_dir: Path,
    prompt: str,
    edit_idx: int,
    object_idx: int,
    timestamp: int,
    *,
    image_batch_cache_size: int = 8,
    num_stages: int = 1,
    num_iterations_per_stage: int = 2000,
    scale_factor: float = 2.0,
    learning_rate: float = 0.03,
    lr_decay_gamma_per_stage: float = 0.1,
    lr_decay_steps_per_stage: int = 1000,
    stagewise_lr_decay_gamma: float = 0.9,
    render_feedback_pose: Optional[CameraPose] = None,
    save_freq: int = 1000,
    feedback_freq: int = 100,
    summary_freq: int = 10,
    apply_diffuse_render_regularization: bool = False,
    verbose_rendering: bool = True,
    fast_debug_mode: bool = False,
    directional_dataset: bool = False,
    attn_tv_weight: float = 0.001,
    refine_freq: int = 1000,
    kval: float = 5.0,
    relearn_attn_grids: bool = False,
    edit_mask_thresh: float = 0.992,
    num_obj_voxels_thresh: int = 5000,
    min_num_edit_voxels: int = 300,
    top_k_edit_thresh: int = 300,
    top_k_obj_thresh: int = 200,
    downsample_refine_grid: bool = False,
    sd_model: Optional[StableDiffusion] = None,
    sd_version: str = "1.4",
    sd_weights_dir: Optional[Path] = None,
    sd_config=None,
    use_shear_warp: bool = True,
    shear_warp_base_res: Optional[int] = None,
    seed: int = 42,
    device: Optional[torch.device] = None,
) -> VolumetricModel:
    """The legacy iterate-and-refine loop on the models' device (`device`
    moves the four models' tensors there first). Mutates `vol_mod_sds` to
    the latest merge and the attention models to the re-learned grids;
    returns `vol_mod_edit`. Its last log record carries `time_training`
    (seconds of the loop as the JAX package counts them: the cuts and their
    feedback renders in, the attention feedback and the saves out),
    `relearn_s` (the re-learn steps alone), `graph_cut_s` (the cuts and
    merges alone) and `num_cuts`."""
    assert prompt != "none", "you have to supply a text prompt to use SDS"
    models = (vol_mod_edit, vol_mod_object, vol_mod_sds, vol_mod_ref)
    if device is not None:
        for vm in models:
            vm.grid = vm.grid.replace(**{
                f: getattr(vm.grid, f).to(device) for f in ("densities", "features", "attn", "orig_densities")
                if getattr(vm.grid, f) is not None
            })
    dev = vol_mod_edit.grid.densities.device

    # SD is built only for the re-learn (the reference always builds it)
    sd = sd_model
    if relearn_attn_grids and sd is None:
        sd = StableDiffusion(sd_version, config=sd_config, weights_dir=sd_weights_dir, device=dev)

    camera_intrinsics = train_dataset.camera_intrinsics
    im_h, im_w = camera_intrinsics.height, camera_intrinsics.width
    extra_info = {
        CAMERA_BOUNDS: list(train_dataset.camera_bounds),
        CAMERA_INTRINSICS: list(camera_intrinsics),
        HEMISPHERICAL_RADIUS: train_dataset.get_hemispherical_radius_estimate(),
    }

    output_dir = Path(output_dir)
    model_dir = output_dir / "saved_models"
    logs_dir = output_dir / "training_logs"
    render_dir = logs_dir / "rendered_output"
    for d in (model_dir, logs_dir, logs_dir / "tensorboard", render_dir):
        d.mkdir(parents=True, exist_ok=True)
    try:
        from tensorboardX import SummaryWriter

        tb_writer = SummaryWriter(str(logs_dir / "tensorboard"))
    except ImportError:
        tb_writer = None

    stagewise_sizes = compute_thre3d_grid_sizes(vol_mod_edit.grid.grid_dims, num_stages, scale_factor)
    if num_stages > 1:
        _scale_all(models, stagewise_sizes[0])

    if render_feedback_pose is None:  # the last dataset view
        pose_arr = train_dataset.poses[-1]
        render_feedback_pose = CameraPose(rotation=pose_arr[:, :3], translation=pose_arr[:, 3:])
    if not fast_debug_mode:
        from voxe_tpu_torch.viz.static import visualize_camera_rays

        visualize_camera_rays(train_dataset, output_dir, num_rays_per_image=1)
    sw_res = shear_warp_base_res or max(im_h, im_w)
    sw_hw = (sw_res, sw_res)

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch_iter = train_dataset.iter_batches(min(image_batch_cache_size, len(train_dataset)), rng)

    log.info("beginning training (legacy grid_refine loop)")
    time_training = relearn_s = graph_cut_s = 0.0
    num_cuts = 0

    def cut_and_merge(global_step: int) -> None:
        nonlocal graph_cut_s, num_cuts
        t0 = time.perf_counter()
        get_edit_region(
            vol_mod_edit=vol_mod_edit,
            vol_mod_object=vol_mod_object,
            vol_mod_output=vol_mod_sds,
            K=kval,
            edit_mask_thresh=edit_mask_thresh,
            num_obj_voxels_thresh=num_obj_voxels_thresh,
            min_num_edit_voxels=min_num_edit_voxels,
            top_k_edit_thresh=top_k_edit_thresh,
            top_k_obj_thresh=top_k_obj_thresh,
            downsample_grid=downsample_refine_grid,
        )
        merge_edit_region(vol_mod_sds, vol_mod_ref)
        graph_cut_s += time.perf_counter() - t0
        num_cuts += 1
        if not fast_debug_mode:
            from voxe_tpu_torch.viz.static import visualize_sh_vox_grid_vol_mod_rendered_feedback

            visualize_sh_vox_grid_vol_mod_rendered_feedback(
                vol_mod_sds, "sds_refined", render_feedback_pose, camera_intrinsics, global_step, render_dir,
                training_time=time_training, log_diffuse_rendered_version=apply_diffuse_render_regularization,
                verbose_rendering=verbose_rendering, use_shear_warp=use_shear_warp,
            )

    for stage in range(1, num_stages + 1):
        # fresh optimizers over the attention grids each stage: in-stage
        # staircase decay, stagewise decay
        current_stage_lr = learning_rate * (stagewise_lr_decay_gamma ** (stage - 1))
        if relearn_attn_grids:
            from voxe_tpu_torch.render.shearwarp import orient_base_image, render_shear_warp

            schedule = exponential_decay_staircase(current_stage_lr, lr_decay_steps_per_stage, lr_decay_gamma_per_stage)
            edit_attn = vol_mod_edit.grid.attn.detach().clone()
            obj_attn = vol_mod_object.grid.attn.detach().clone()
            optimizer_edit = make_attn_adam(edit_attn, current_stage_lr)
            optimizer_object = make_attn_adam(obj_attn, current_stage_lr)
            base_grid = vol_mod_edit.grid.replace(
                densities=vol_mod_edit.grid.densities.detach(), features=vol_mod_edit.grid.features.detach()
            )
            dual_update = make_dual_attn_update(
                vol_mod_edit.render_config, optimizer_edit, optimizer_object, base_grid, sw_hw, attn_tv_weight,
                schedule,
            )
            frame_config = vol_mod_edit.render_config.replace(stochastic_density_noise_std=0.0)
        log.info(f"training stage: {stage}  voxel grid resolution: {vol_mod_edit.grid.grid_dims}  lr: {current_stage_lr}")
        last_time = time.perf_counter()

        for stage_iteration in range(1, num_iterations_per_stage + 1):
            global_step = (stage - 1) * num_iterations_per_stage + stage_iteration
            pose_arr = train_dataset.poses[next(batch_iter)[-1]]
            direction = get_dir_batch_from_poses_legacy(pose_arr[None])[0]
            if directional_dataset and tb_writer is not None:
                tb_writer.add_scalar("Input Direction", DIR_TO_NUM_DICT[direction], global_step)

            metrics = None
            if relearn_attn_grids:
                rot = torch.as_tensor(np.asarray(pose_arr[:, :3], np.float32), device=dev)
                trans = torch.as_tensor(np.asarray(pose_arr[:, 3:], np.float32), device=dev).reshape(3, 1)
                with torch.no_grad():
                    out, _ = render_shear_warp(
                        base_grid.replace(attn=edit_attn.detach()), CameraPose(rot, trans), frame_config,
                        base_hw=sw_hw,
                    )
                    pred_rgb = orient_base_image(out.colour.reshape(*sw_hw, 3), rot)[None]
                gt_maps, _ = sd.get_attn_map(
                    prompt + f", {direction} view", pred_rgb, timestamp, [edit_idx, object_idx], generator=gen
                )
                metrics = dual_update(edit_attn, obj_attn, rot, trans, gt_maps[0], gt_maps[1], gen)
                vol_mod_edit.grid = vol_mod_edit.grid.replace(attn=edit_attn.detach())
                vol_mod_object.grid = vol_mod_object.grid.replace(attn=obj_attn.detach())
                _sync(dev)
                relearn_s += time.perf_counter() - last_time

            if global_step % refine_freq == 0 or global_step == 1:
                cut_and_merge(global_step)

            _sync(dev)
            time_training += time.perf_counter() - last_time

            if metrics is not None and (global_step % summary_freq == 0 or stage_iteration == 1):
                if tb_writer is not None:
                    for name, value in metrics.items():
                        tb_writer.add_scalar(name, float(value), global_step)
                log.info(f"Stage: {stage} Iteration: {global_step} attn_loss_edit: {float(metrics['attn_loss_edit']):.4f}")

            last_iter = stage_iteration == num_iterations_per_stage
            if (global_step % feedback_freq == 0 or stage_iteration == 1 or last_iter) and not fast_debug_mode:
                from voxe_tpu_torch.viz.static import visualize_sh_vox_grid_vol_mod_rendered_feedback_attn

                log.info(f"TIME CHECK: time spent actually training till now: {timedelta(seconds=time_training)}")
                visualize_sh_vox_grid_vol_mod_rendered_feedback_attn(
                    vol_mod_sds, "attn", render_feedback_pose, camera_intrinsics, global_step, render_dir,
                    use_shear_warp=use_shear_warp,
                )

            if global_step % save_freq == 0 or stage_iteration == 1 or last_iter:
                log.info(f"saving model-snapshot at stage {stage}, global step {global_step}")
                vol_mod_edit.save(model_dir / f"model_edit_stage_{stage}_iter_{global_step}.pth", extra_info=extra_info)
                vol_mod_object.save(
                    model_dir / f"model_pbject_stage_{stage}_iter_{global_step}.pth", extra_info=extra_info
                )
            last_time = time.perf_counter()

        if stage != num_stages:
            _scale_all(models, stagewise_sizes[stage])

    log.info("Saving the final model-snapshots")
    vol_mod_edit.save(model_dir / "model_final_edit.pth", extra_info=extra_info)
    vol_mod_object.save(model_dir / "model_final_object.pth", extra_info=extra_info)
    vol_mod_sds.save(model_dir / "model_final_sds.pth", extra_info=extra_info)
    if tb_writer is not None:
        tb_writer.close()
    log.info(
        f"Training complete; total actual training time: {timedelta(seconds=time_training)}",
        extra={"time_training": time_training, "relearn_s": relearn_s, "graph_cut_s": graph_cut_s,
               "num_cuts": num_cuts, "iterations": num_stages * num_iterations_per_stage},
    )
    return vol_mod_edit

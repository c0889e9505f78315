"""CLI: edit a pretrained voxel grid toward a text prompt with Score
Distillation Sampling, with the PyTorch port (counterpart of
edit_pretrained_relu_field.py: the same flag names and defaults, parsed with
argparse, plus `--device`).

    python -m voxe_tpu_torch.cli.edit_pretrained_relu_field \\
        -i recon/saved_models/model_final.pth -o edit -p "a dog wearing a hat" \\
        -d scene [--sd_weights_dir sd2_snapshot] [--device cpu]

`--sd_weights_dir` points at a local HF snapshot (text_encoder/, vae/,
unet/, tokenizer/; for `--sd_version xl` also text_encoder_2/ and, when
present, tokenizer_2/); without it the SD weights are seeded random.
`--do_refinement True` then refines the edit on SD 1.4 (`-eidx` names the
edit tokens; `--sd_refine_weights_dir` is the 1.4 snapshot, required when
`--sd_weights_dir` is given), writing `model_final_refined.pth`;
`--post_process_scc True` keeps the largest connected component of the
final model's density. `--num_devices N` shards the edit and the
refinement over N devices, one process each (spawned by the command, or the
group of torchrun or `--multihost True`), as the recon CLI does.
`--hf_auth_token`, `--num_workers` and the wandb flags are accepted and
unused, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import copy
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import (
    _bool,
    _min_one,
    check_device,
    load_train_dataset,
)
from voxe_tpu_torch.models.volumetric import VolumetricModel, load_volumetric_model
from voxe_tpu_torch.parallel.distributed import barrier, init_cli_group, is_local_writer, spawn_cli_ranks
from voxe_tpu_torch.parallel.mesh import maybe_mesh
from voxe_tpu_torch.train.sds import train_sh_vox_grid_vol_mod_with_posed_images_and_sds
from voxe_tpu_torch.utils.constants import CAMERA_BOUNDS, CAMERA_INTRINSICS, HEMISPHERICAL_RADIUS
from voxe_tpu_torch.utils.misc import log_config_to_disk


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="edit a pretrained voxel grid with SDS (PyTorch port)")
    a = p.add_argument
    a("-i", "--ref_model_path", required=True, help="path to the pre-trained relu field model")
    a("-o", "--output_path", required=True, help="path for training output")
    a("-p", "--prompt", required=True, help="sds prompt used for SDS based loss")
    a("-d", "--data_path", required=True, help="path to the input dataset")
    a("-a", "--hf_auth_token", default="", help="unused; kept for flag parity")
    a("-eidx", "--edit_idx", default=None, help="refinement: index of the edit token(s)")
    a("-oidx", "--object_idx", type=int, default=None, help="refinement: index of the object token")
    a("-t", "--timestamp", type=int, default=200, help="refinement: diffusion timestamp")
    a("--separate_train_test_folders", type=_bool, default=True)
    a("--data_downsample_factor", type=_min_one, default=3.0)
    # grid flags are kept for parity: the grid comes from the checkpoint
    a("--grid_dims", type=int, nargs=3, default=(160, 160, 160))
    a("--grid_location", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    a("--normalize_scene_scale", type=_bool, default=False)
    a("--grid_world_size", type=float, nargs=3, default=(3.0, 3.0, 3.0))
    a("--sh_degree", type=int, default=0)
    a("--use_relu_field", type=_bool, default=True)
    a("--use_softplus_field", type=_bool, default=True)
    a("--render_num_samples_per_ray", type=int, default=512)
    a("--parallel_rays_chunk_size", type=int, default=32768)
    a("--white_bkgd", type=_bool, default=True)
    a("--ray_batch_size", type=int, default=84672)
    a("--train_num_samples_per_ray", type=int, default=256)
    a("--num_iterations_edit", type=int, default=8000)
    a("--scale_factor", type=float, default=2.0)
    a("--learning_rate", type=float, default=0.03)
    a("--learning_rate_attn_learning", type=float, default=0.035)
    a("--lr_freq", type=int, default=400)
    a("--lr_decay_start", type=int, default=5000)
    a("--lr_gamma", type=float, default=0.96)
    a("--apply_diffuse_render_regularization", type=_bool, default=True)
    a("--num_workers", type=int, default=4, help="unused; kept for flag parity")
    a("--log_wandb", type=_bool, default=False, help="unused; kept for flag parity")
    a("--wandb_username", default="etaisella", help="unused; kept for flag parity")
    a("--wandb_project_name", default="Vox-E", help="unused; kept for flag parity")
    a("--save_frequency", type=int, default=500)
    a("--test_frequency", type=int, default=500)
    a("--feedback_frequency", type=int, default=200)
    a("--summary_frequency", type=int, default=50)
    a("--verbose_rendering", type=_bool, default=False)
    a("--fast_debug_mode", type=_bool, default=False)
    a("--do_sds", type=_bool, default=True)
    a("--downsample_refine_grid", type=_bool, default=False)
    a("--new_frame_frequency", type=int, default=1)
    a("--density_correlation_weight", type=float, default=200.0)
    a("--feature_correlation_weight", type=float, default=0.0)
    a("--tv_density_weight", type=float, default=0.0)
    a("--tv_features_weight", type=float, default=0.0)
    a("--sds_t_freq", type=int, default=600)
    a("--sds_t_start", type=int, default=4000)
    a("--sds_t_gamma", type=float, default=0.75)
    a("--do_refinement", type=_bool, default=False)
    a("--kval", type=float, default=5.0)
    a("--edit_mask_thresh", type=float, default=0.992)
    a("--num_obj_voxels_thresh", type=int, default=5000)
    a("--min_num_edit_voxels", type=int, default=300)
    a("--top_k_edit_thresh", type=int, default=300)
    a("--top_k_obj_thresh", type=int, default=200)
    a("--attn_tv_weight", type=float, default=0.01)
    a("--num_iterations_refine", type=int, default=1500)
    a("--uncoupled_mode", type=_bool, default=False)
    a("--data_pose_mode", type=_bool, default=False)
    a("--uncoupled_l2_mode", type=_bool, default=False)
    a("--l2_mode", type=_bool, default=False)
    a("--l1_mode", type=_bool, default=False)
    a("--post_process_scc", type=_bool, default=False)
    a("--sd_weights_dir", default=None, help="local HF snapshot of the SD weights; seeded random without it")
    a("--sd_version", default="2.0", help="2.0, 2.1, 1.4, 1.5, xl (SDXL base 1.0 at 1024^2) or tiny")
    a("--sd_refine_weights_dir", default=None, help="refinement: SD 1.4 snapshot")
    a("--steps_per_call", type=int, default=1)
    a("--multihost", type=_bool, default=False)
    a("--num_devices", type=int, default=1)
    a("--use_shear_warp", type=_bool, default=True)
    a("--shear_warp_base_res", type=int, default=None)
    a("--device", default="cuda", help="torch device of the grid, the data, SD and the training")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Optional[VolumetricModel]:
    """Run the edit, then the refinement and the SCC post-process when asked;
    returns the edited model (also saved as
    `<output_path>/saved_models/model_final.pth`), or None in the process
    that spawned the ranks of a multi-device run."""
    parser = build_parser()
    config = parser.parse_args(argv)
    if config.do_refinement:
        if config.edit_idx is None:
            parser.error("--do_refinement needs -eidx / --edit_idx (the edit token indices)")
        if config.sd_weights_dir is not None and config.sd_refine_weights_dir is None and config.sd_version != "tiny":
            # fail before the edit: the --sd_weights_dir snapshot is SD 2.x and
            # cannot load into the 1.4 architecture the refinement uses
            parser.error(
                "--do_refinement with real SD weights needs --sd_refine_weights_dir pointing at a "
                "converted SD **1.4** snapshot (refinement uses 1.4)"
            )
    check_device(config.device)
    if spawn_cli_ranks(main, argv, config):
        return None
    init_cli_group(config)
    writer = is_local_writer()
    output_path = Path(config.output_path)
    if writer:
        log_config_to_disk(vars(config), output_path)
    train_dataset = load_train_dataset(config)
    intrinsics = train_dataset.camera_intrinsics

    pretrained_vol_mod, _ = load_volumetric_model(Path(config.ref_model_path), device=config.device)
    sds_vol_mod = VolumetricModel(
        copy.deepcopy(pretrained_vol_mod.grid),
        pretrained_vol_mod.render_config.replace(
            num_samples_per_ray=config.train_num_samples_per_ray,
            render_num_samples_per_ray=config.render_num_samples_per_ray,
            parallel_rays_chunk_size=config.parallel_rays_chunk_size,
            white_bkgd=config.white_bkgd,
        ),
        dict(pretrained_vol_mod.extra_info),
    )
    edited = train_sh_vox_grid_vol_mod_with_posed_images_and_sds(
        sds_vol_mod=sds_vol_mod,
        pretrained_vol_mod=pretrained_vol_mod,
        train_dataset=train_dataset,
        image_dims=(intrinsics.height, intrinsics.width),
        output_dir=output_path,
        ray_batch_size=config.ray_batch_size,
        num_iterations=config.num_iterations_edit,
        scale_factor=config.scale_factor,
        learning_rate=config.learning_rate,
        lr_decay_start=config.lr_decay_start,
        lr_freq=config.lr_freq,
        lr_gamma=config.lr_gamma,
        save_freq=config.save_frequency,
        feedback_freq=config.feedback_frequency,
        summary_freq=config.summary_frequency,
        apply_diffuse_render_regularization=config.apply_diffuse_render_regularization,
        verbose_rendering=config.verbose_rendering,
        sds_prompt=config.prompt,
        new_frame_frequency=config.new_frame_frequency,
        density_correlation_weight=config.density_correlation_weight,
        feature_correlation_weight=config.feature_correlation_weight,
        tv_density_weight=config.tv_density_weight,
        tv_features_weight=config.tv_features_weight,
        do_sds=config.do_sds,
        sds_t_freq=config.sds_t_freq,
        sds_t_start=config.sds_t_start,
        sds_t_gamma=config.sds_t_gamma,
        uncoupled_mode=config.uncoupled_mode,
        data_pose_mode=config.data_pose_mode,
        uncoupled_l2_mode=config.uncoupled_l2_mode,
        l2_mode=config.l2_mode,
        l1_mode=config.l1_mode,
        sd_version=config.sd_version,
        sd_weights_dir=Path(config.sd_weights_dir) if config.sd_weights_dir else None,
        fast_debug_mode=config.fast_debug_mode,
        mesh=maybe_mesh(config.num_devices),
        steps_per_call=config.steps_per_call,
        use_shear_warp=config.use_shear_warp,
        shear_warp_base_res=config.shear_warp_base_res,
    )
    saved = output_path / "saved_models"
    barrier()  # every rank reads what the writer saved
    if config.do_refinement:
        from voxe_tpu_torch.train.refine import refine_edited_relu_field

        vol_mod_edit, vol_mod_obj, vol_mod_output = (
            load_volumetric_model(saved / "model_final.pth", device=config.device, with_attn=True)[0]
            for _ in range(3)
        )
        refine_edited_relu_field(
            vol_mod_edit=vol_mod_edit,
            vol_mod_object=vol_mod_obj,
            vol_mod_ref=pretrained_vol_mod,
            vol_mod_output=vol_mod_output,
            train_dataset=train_dataset,
            output_dir=output_path,
            prompt=config.prompt,
            edit_idx=[int(i) for i in config.edit_idx.split()],
            object_idx=config.object_idx,
            timestamp=config.timestamp,
            image_dims=(intrinsics.height, intrinsics.width),
            ray_batch_size=config.ray_batch_size,
            num_iterations=config.num_iterations_refine,
            learning_rate=config.learning_rate_attn_learning,
            save_freq=config.save_frequency,
            feedback_freq=config.feedback_frequency,
            summary_freq=config.summary_frequency,
            apply_diffuse_render_regularization=config.apply_diffuse_render_regularization,
            verbose_rendering=config.verbose_rendering,
            attn_tv_weight=config.attn_tv_weight,
            kval=config.kval,
            edit_mask_thresh=config.edit_mask_thresh,
            num_obj_voxels_thresh=config.num_obj_voxels_thresh,
            min_num_edit_voxels=config.min_num_edit_voxels,
            top_k_edit_thresh=config.top_k_edit_thresh,
            top_k_obj_thresh=config.top_k_obj_thresh,
            data_pose_mode=config.data_pose_mode,
            downsample_refine_grid=config.downsample_refine_grid,
            sd_weights_dir=Path(config.sd_refine_weights_dir) if config.sd_refine_weights_dir else None,
            # the reference refines on SD 1.4, unless the tiny plumbing config was asked for
            sd_version="tiny" if config.sd_version == "tiny" else "1.4",
            num_devices=config.num_devices,
            use_shear_warp=config.use_shear_warp,
            shear_warp_base_res=config.shear_warp_base_res,
            steps_per_call=config.steps_per_call,
        )
    if config.post_process_scc and writer:
        from voxe_tpu_torch.seg.components import scc_post_process

        target = saved / ("model_final_refined.pth" if config.do_refinement else "model_final.pth")
        vol_mod, _ = load_volumetric_model(target, device=config.device, with_attn=config.do_refinement)
        new_densities = scc_post_process(
            vol_mod.grid.densities.cpu().numpy(), pretrained_vol_mod.grid.densities.cpu().numpy()
        )
        vol_mod.grid = vol_mod.grid.replace(densities=torch.from_numpy(new_densities).to(config.device))
        vol_mod.save(target, extra_info={
            CAMERA_BOUNDS: list(train_dataset.camera_bounds),
            CAMERA_INTRINSICS: list(intrinsics),
            HEMISPHERICAL_RADIUS: train_dataset.get_hemispherical_radius_estimate(),
        })
    return edited


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

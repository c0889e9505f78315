"""CLI: refinement of an edited grid with the PyTorch port — train the edit
and object attention grids against SD's cross-attention maps, graph-cut
them and merge the edit region into the reference model (counterpart of
refine_edited_relu_field.py: the same flag names and defaults, parsed with
argparse, plus `--device`).

    python -m voxe_tpu_torch.cli.refine_edited_relu_field \\
        -d scene -i edit/saved_models/model_final.pth \\
        -r recon/saved_models/model_final.pth -o refine \\
        -p "a dog wearing a party hat" -eidx "4 5" [--sd_weights_dir sd14] [--device cpu]

`--sd_weights_dir` points at a local HF snapshot of SD 1.4; without it the
SD weights are seeded random. `--steps_per_call K` runs K shear-warp
iterations a call in random-pose mode. `--multihost` and `--num_devices > 1`
raise (not ported). `--hf_auth_token`, `--num_workers`
and the wandb flags are accepted and unused, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import (
    _bool,
    _min_one,
    check_device,
    load_train_dataset,
)
from voxe_tpu_torch.models.volumetric import load_volumetric_model
from voxe_tpu_torch.train.refine import refine_edited_relu_field
from voxe_tpu_torch.utils.misc import log_config_to_disk


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="refine an edited voxel grid with attention grids (PyTorch port)")
    a = p.add_argument
    a("-d", "--data_path", required=True, help="path to the input dataset")
    a("-i", "--sds_model_path", required=True, help="path to the pre-trained sds model")
    a("-o", "--output_path", required=True, help="path for training output")
    a("-r", "--ref_model_path", required=True, help="path to the pre-trained model")
    a("-a", "--hf_auth_token", default="", help="unused; kept for flag parity")
    a("-p", "--prompt", required=True, help="prompt used for attention extraction")
    a("-eidx", "--edit_idx", required=True, help="space-separated edit token indices")
    a("-oidx", "--object_idx", type=int, default=None, help="object token index")
    a("-t", "--timestamp", type=int, default=200, help="diffusion timestamp")
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
    a("--render_num_samples_per_ray", type=int, default=1024)
    a("--parallel_rays_chunk_size", type=int, default=32768)
    a("--white_bkgd", type=_bool, default=True)
    a("--ray_batch_size", type=int, default=84672)
    a("--train_num_samples_per_ray", type=int, default=256)
    a("--num_stages", type=int, default=1)
    a("--num_iterations_per_stage", type=int, default=1500)
    a("--scale_factor", type=float, default=2.0)
    a("--learning_rate", type=float, default=0.028)
    a("--lr_decay_steps_per_stage", type=int, default=5000 * 100)
    a("--lr_decay_gamma_per_stage", type=float, default=0.1)
    a("--stagewise_lr_decay_gamma", type=float, default=0.9)
    a("--apply_diffuse_render_regularization", type=_bool, default=True)
    a("--num_workers", type=int, default=4, help="unused; kept for flag parity")
    a("--save_frequency", type=int, default=250)
    a("--test_frequency", type=int, default=250)
    a("--feedback_frequency", type=int, default=200)
    a("--summary_frequency", type=int, default=50)
    a("--verbose_rendering", type=_bool, default=False)
    a("--data_pose_mode", type=_bool, default=False, help="use dataset poses instead of random sampling")
    a("--directional_dataset", type=_bool, default=True)
    a("--downsample_refine_grid", type=_bool, default=False)
    a("--kval", type=float, default=5.0)
    a("--edit_mask_thresh", type=float, default=0.992)
    a("--num_obj_voxels_thresh", type=int, default=5000)
    a("--min_num_edit_voxels", type=int, default=300)
    a("--top_k_edit_thresh", type=int, default=300)
    a("--top_k_obj_thresh", type=int, default=200)
    a("--attn_tv_weight", type=float, default=0.01)
    a("--log_wandb", type=_bool, default=False, help="unused; kept for flag parity")
    a("--wandb_username", default="etaisella", help="unused; kept for flag parity")
    a("--wandb_project_name", default="Vox-E-refine", help="unused; kept for flag parity")
    a("--sd_weights_dir", default=None, help="local HF snapshot of SD 1.4; seeded random without it")
    a("--sd_version", default="1.4", help="SD version for attention extraction")
    a("--multihost", type=_bool, default=False)
    a("--num_devices", type=int, default=1)
    a("--shear_warp_base_res", type=int, default=None)
    a("--use_shear_warp", type=_bool, default=True)
    a("--steps_per_call", type=int, default=1)
    a("--device", default="cuda", help="torch device of the grids, the data, SD and the training")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    config = build_parser().parse_args(argv)
    if config.multihost or config.num_devices > 1:
        raise NotImplementedError("--multihost / --num_devices > 1: multi-device refinement is not ported yet")
    check_device(config.device)
    output_path = Path(config.output_path)
    log_config_to_disk(vars(config), output_path)
    train_dataset = load_train_dataset(config)
    intrinsics = train_dataset.camera_intrinsics

    dev = config.device
    pretrained_vol_mod, _ = load_volumetric_model(Path(config.ref_model_path), device=dev)
    vol_mod_edit, vol_mod_obj, vol_mod_output = (
        load_volumetric_model(Path(config.sds_model_path), device=dev, with_attn=True)[0] for _ in range(3)
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
        num_iterations=config.num_iterations_per_stage,
        learning_rate=config.learning_rate,
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
        sd_version=config.sd_version,
        sd_weights_dir=Path(config.sd_weights_dir) if config.sd_weights_dir else None,
        use_shear_warp=config.use_shear_warp,
        shear_warp_base_res=config.shear_warp_base_res,
        steps_per_call=config.steps_per_call,
    )


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

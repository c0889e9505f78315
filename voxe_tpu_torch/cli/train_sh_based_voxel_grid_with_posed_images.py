"""CLI: reconstruct an SH voxel grid from posed images with the PyTorch port
(counterpart of train_sh_based_voxel_grid_with_posed_images.py: the same
flag names and defaults, parsed with argparse, plus `--device`).

    python -m voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images \\
        -d scene -o out --fast_debug_mode True [--device cpu]

`--steps_per_call K` runs K steps a call, `--resume` continues from a
`training_state_latest.pth` of either package, `--coarse_stages_on_cpu True`
trains every stage but the last on the CPU, and a scene that decodes to more
than 4 GiB streams its pixels from a memmap. `--num_devices N` batches the
rays data-parallel over N devices, one process each: the command spawns N
local ranks itself, or, under torchrun or with `--multihost True`, joins the
launched group (whose size must be N). Only local rank 0 writes files.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelGridLocation, VoxelSize
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.parallel.distributed import init_cli_group, is_local_writer, spawn_cli_ranks
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.train.recon import train_sh_vox_grid_vol_mod_with_posed_images
from voxe_tpu_torch.utils.constants import NUM_COLOUR_CHANNELS
from voxe_tpu_torch.utils.misc import compute_expected_density_scale_for_relu_field_grid, log_config_to_disk


def _bool(text: str) -> bool:
    """click.BOOL's spellings."""
    value = text.strip().lower()
    if value in ("1", "true", "t", "yes", "y", "on"):
        return True
    if value in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"{text!r} is not a valid boolean")


def check_device(device: str) -> None:
    """Entry points run on the card unless the caller asks for the CPU."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")


def load_train_dataset(config) -> PosedImagesDataset:
    """The training split in the JAX CLIs' layout (`train/` with
    train_camera_params.json, or `images/` with camera_params.json)."""
    data_path = Path(config.data_path)
    split = ("train", "train_camera_params.json") if config.separate_train_test_folders else (
        "images", "camera_params.json")
    return PosedImagesDataset(
        images_dir=data_path / split[0], camera_params_json=data_path / split[1],
        normalize_scene_scale=getattr(config, "normalize_scene_scale", False),
        downsample_factor=config.data_downsample_factor,
        rgba_white_bkgd=getattr(config, "white_bkgd", True), device=config.device,
    )


def _min_one(text: str) -> float:
    value = float(text)
    if value < 1.0:
        raise argparse.ArgumentTypeError(f"{value} is smaller than the minimum 1.0")
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="reconstruct an SH voxel grid from posed images (PyTorch port)")
    a = p.add_argument
    a("-d", "--data_path", required=True, help="path to the input dataset")
    a("-o", "--output_path", required=True, help="path for training output")
    a("--separate_train_test_folders", type=_bool, default=True)
    a("--data_downsample_factor", type=_min_one, default=1.0)
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
    a("--linear_disparity_sampling", type=_bool, default=False)
    a("--optimized_sampling", type=_bool, default=False)
    a("--ray_batch_size", type=int, default=32768)
    a("--train_num_samples_per_ray", type=int, default=256)
    a("--num_stages", type=int, default=4)
    a("--num_iterations_per_stage", type=int, default=500)
    a("--scale_factor", type=float, default=2.0)
    a("--learning_rate", type=float, default=0.03)
    a("--lr_decay_steps_per_stage", type=int, default=400)
    a("--lr_decay_gamma_per_stage", type=float, default=0.1)
    a("--stagewise_lr_decay_gamma", type=float, default=0.9)
    a("--apply_diffuse_render_regularization", type=_bool, default=True)
    a("--num_workers", type=int, default=4, help="unused; kept for flag parity")
    a("--save_frequency", type=int, default=250)
    a("--test_frequency", type=int, default=250)
    a("--feedback_frequency", type=int, default=100)
    a("--summary_frequency", type=int, default=50)
    a("--verbose_rendering", type=_bool, default=False)
    a("--fast_debug_mode", type=_bool, default=False)
    a("--lpips_weight", type=float, default=0.0, help="unused; kept for flag parity")
    a("--gather_dtype", choices=["float32", "bfloat16"], default="bfloat16")
    a("--steps_per_call", type=int, default=1)
    a("--resume", dest="resume_from", default=None)
    a("--coarse_stages_on_cpu", type=_bool, default=False)
    a("--multihost", type=_bool, default=False)
    a("--num_devices", type=int, default=1)
    a("--use_fused_kernel", type=_bool, default=False)
    a("--use_shear_warp", type=_bool, default=True)
    a("--shear_warp_base_res", type=int, default=None)
    a("--device", default="cuda", help="torch device of the grid, the data and the training")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    config = build_parser().parse_args(argv)
    check_device(config.device)
    if spawn_cli_ranks(main, argv, config):
        return
    init_cli_group(config)
    data_path, output_path = Path(config.data_path), Path(config.output_path)
    if is_local_writer():
        log_config_to_disk(vars(config), output_path)

    def dataset(images_dir, params_json):
        return PosedImagesDataset(
            images_dir=images_dir, camera_params_json=params_json,
            normalize_scene_scale=config.normalize_scene_scale,
            downsample_factor=config.data_downsample_factor,
            rgba_white_bkgd=config.white_bkgd, device=config.device,
        )

    if config.separate_train_test_folders:
        train_dataset = dataset(data_path / "train", data_path / "train_camera_params.json")
        test_dataset = dataset(data_path / "test", data_path / "test_camera_params.json")
    else:
        train_dataset = dataset(data_path / "images", data_path / "camera_params.json")
        test_params = data_path / "test_camera_params.json"
        test_dataset = dataset(data_path / "images", test_params) if test_params.exists() else None

    # density activation: softplus field wins over relu field when both are on
    if config.use_softplus_field or config.use_relu_field:
        activations = dict(
            density_preactivation="identity",
            density_postactivation="softplus" if config.use_softplus_field else "relu",
            expected_density_scale=compute_expected_density_scale_for_relu_field_grid(config.grid_world_size),
        )
    else:
        activations = dict(density_preactivation="abs", density_postactivation="identity", expected_density_scale=1.0)

    num_sh_features = NUM_COLOUR_CHANNELS * ((config.sh_degree + 1) ** 2)
    grid_config = VoxelGridConfig(
        voxel_size=VoxelSize(*[s / d for s, d in zip(config.grid_world_size, config.grid_dims)]),
        grid_location=VoxelGridLocation(*config.grid_location),
        gather_dtype=config.gather_dtype,
        **activations,
    )
    # placeholder tensors; the trainer re-randomises at the coarsest stage
    grid = VoxelGrid(
        densities=torch.zeros((*config.grid_dims, 1), device=config.device),
        features=torch.zeros((*config.grid_dims, num_sh_features), device=config.device),
        config=grid_config,
    )
    vol_mod = VolumetricModel(
        grid,
        SHVoxGridRenderConfig(
            num_samples_per_ray=config.train_num_samples_per_ray,
            camera_bounds=train_dataset.camera_bounds,
            white_bkgd=config.white_bkgd,
            render_num_samples_per_ray=config.render_num_samples_per_ray,
            parallel_rays_chunk_size=config.parallel_rays_chunk_size,
            optimized_sampling=config.optimized_sampling,
            linear_disparity_sampling=config.linear_disparity_sampling,
            use_fused_kernel=config.use_fused_kernel,
        ),
    )
    train_sh_vox_grid_vol_mod_with_posed_images(
        vol_mod=vol_mod,
        train_dataset=train_dataset,
        output_dir=output_path,
        test_dataset=test_dataset,
        ray_batch_size=config.ray_batch_size,
        num_stages=config.num_stages,
        num_iterations_per_stage=config.num_iterations_per_stage,
        scale_factor=config.scale_factor,
        learning_rate=config.learning_rate,
        lr_decay_gamma_per_stage=config.lr_decay_gamma_per_stage,
        lr_decay_steps_per_stage=config.lr_decay_steps_per_stage,
        stagewise_lr_decay_gamma=config.stagewise_lr_decay_gamma,
        save_freq=config.save_frequency,
        test_freq=config.test_frequency,
        feedback_freq=config.feedback_frequency,
        summary_freq=config.summary_frequency,
        apply_diffuse_render_regularization=config.apply_diffuse_render_regularization,
        verbose_rendering=config.verbose_rendering,
        fast_debug_mode=config.fast_debug_mode,
        steps_per_call=config.steps_per_call,
        resume_from=Path(config.resume_from) if config.resume_from else None,
        coarse_stages_on_cpu=config.coarse_stages_on_cpu,
        num_devices=config.num_devices,
        use_shear_warp=config.use_shear_warp,
        shear_warp_base_res=config.shear_warp_base_res,
    )


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

"""CLI: graph-cut segmentation and voxel merge from trained edit / object
attention grids, with the PyTorch port (counterpart of
segment_attn_relu_field.py: the same flag names and defaults, parsed with
argparse, plus `--device`).

    python -m voxe_tpu_torch.cli.segment_attn_relu_field -d scene \\
        -ie refine/saved_models/model_final_attn_edit.pth \\
        -io refine/saved_models/model_final_attn_object.pth \\
        -r recon/saved_models/model_final.pth -i edit/saved_models/model_final.pth \\
        -o segment [--device cpu]

Writes `saved_models/model_final_refined.pth` and, under
`training_logs/rendered_output`, the graph cut's scatters and the final
attention and colour feedback panels. The wandb flags are accepted and
unused, as in the JAX CLI.
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
from voxe_tpu_torch.seg.graphcut import get_edit_region, merge_edit_region
from voxe_tpu_torch.utils.camera import CameraPose
from voxe_tpu_torch.utils.constants import CAMERA_BOUNDS, CAMERA_INTRINSICS, HEMISPHERICAL_RADIUS
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.misc import log_config_to_disk
from voxe_tpu_torch.viz.static import (
    visualize_sh_vox_grid_vol_mod_rendered_feedback,
    visualize_sh_vox_grid_vol_mod_rendered_feedback_attn,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="graph-cut segmentation and voxel merge (PyTorch port)")
    a = p.add_argument
    a("-d", "--data_path", required=True, help="path to the input dataset")
    a("-ie", "--edit_model_path", required=True, help="path to the trained edit attn model")
    a("-io", "--object_model_path", required=True, help="path to the trained object attn model")
    a("-o", "--output_path", required=True, help="path for output")
    a("-r", "--ref_model_path", required=True, help="path to the pre-trained (reconstruction) model")
    a("-i", "--sds_model_path", required=True, help="path to the edited (sds) model")
    a("--separate_train_test_folders", type=_bool, default=True)
    a("--data_downsample_factor", type=_min_one, default=3.0)
    a("--downsample_refine_grid", type=_bool, default=False)
    a("--kval", type=float, default=5.0)
    a("--edit_mask_thresh", type=float, default=0.992)
    a("--num_obj_voxels_thresh", type=int, default=5000)
    a("--min_num_edit_voxels", type=int, default=300)
    a("--top_k_edit_thresh", type=int, default=300)
    a("--top_k_obj_thresh", type=int, default=200)
    a("--log_wandb", type=_bool, default=False, help="unused; kept for flag parity")
    a("--wandb_username", default="etaisella", help="unused; kept for flag parity")
    a("--wandb_project_name", default="Vox-E-refine", help="unused; kept for flag parity")
    a("--device", default="cuda", help="torch device of the grids and the feedback renders")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    config = build_parser().parse_args(argv)
    check_device(config.device)
    output_path = Path(config.output_path)
    log_config_to_disk(vars(config), output_path)
    train_dataset = load_train_dataset(config)

    dev = config.device
    vol_mod_ref, _ = load_volumetric_model(Path(config.ref_model_path), device=dev)
    vol_mod_edit, _ = load_volumetric_model(Path(config.edit_model_path), device=dev, with_attn=True)
    vol_mod_obj, _ = load_volumetric_model(Path(config.object_model_path), device=dev, with_attn=True)
    vol_mod_output, _ = load_volumetric_model(Path(config.sds_model_path), device=dev, with_attn=True)

    model_dir = output_path / "saved_models"
    render_dir = output_path / "training_logs" / "rendered_output"
    for d in (model_dir, render_dir):
        d.mkdir(parents=True, exist_ok=True)

    log.info("starting grid refinement (graph-cut segmentation)!")
    get_edit_region(
        vol_mod_edit=vol_mod_edit,
        vol_mod_object=vol_mod_obj,
        vol_mod_output=vol_mod_output,
        viz_dir=render_dir,
        K=config.kval,
        edit_mask_thresh=config.edit_mask_thresh,
        num_obj_voxels_thresh=config.num_obj_voxels_thresh,
        min_num_edit_voxels=config.min_num_edit_voxels,
        top_k_edit_thresh=config.top_k_edit_thresh,
        top_k_obj_thresh=config.top_k_obj_thresh,
        downsample_grid=config.downsample_refine_grid,
    )
    merge_edit_region(vol_mod_output, vol_mod_ref)

    pose0 = train_dataset.poses[0]
    feedback_pose = CameraPose(rotation=pose0[:, :3], translation=pose0[:, 3:])
    intrinsics = train_dataset.camera_intrinsics
    visualize_sh_vox_grid_vol_mod_rendered_feedback_attn(
        vol_mod_output, "attn_final", feedback_pose, intrinsics, 0, render_dir
    )
    visualize_sh_vox_grid_vol_mod_rendered_feedback(vol_mod_output, "sds_refined", feedback_pose, intrinsics, 0, render_dir)
    vol_mod_output.save(
        model_dir / "model_final_refined.pth",
        extra_info={
            CAMERA_BOUNDS: list(train_dataset.camera_bounds),
            CAMERA_INTRINSICS: list(intrinsics),
            HEMISPHERICAL_RADIUS: train_dataset.get_hemispherical_radius_estimate(),
        },
    )
    log.info("segmentation + merge complete")


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

"""CLI: render a turntable, spiral or dataset-path video of a trained grid
with the PyTorch port (counterpart of render_sh_based_voxel_grid.py: the
same flag names and defaults, parsed with argparse, plus `--device`).

    python -m voxe_tpu_torch.cli.render_sh_based_voxel_grid \\
        -i recon/saved_models/model_final.pth -o render [--num_frames 180] \\
        [--use_shear_warp True] [--device cpu]

Renders on a white background at the intrinsics and hemisphere radius that
the checkpoint (or `--ref_path`'s) stores, scaled by
`--render_scale_factor`, and writes `rendered_video.mp4` (an MJPEG AVI),
every `--save_freq`-th frame as `frame_<idx>.png` and `--sds_prompt` as
`prompt.txt`. `--num_frames N` gives N - 1 frames on the turntable and the
spiral, as in the reference.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import _bool, check_device
from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.models.volumetric import load_volumetric_model
from voxe_tpu_torch.utils.camera import (
    CameraIntrinsics,
    CameraPose,
    get_thre360_animation_poses,
    get_thre360_spiral_animation_poses,
)
from voxe_tpu_torch.utils.constants import CAMERA_INTRINSICS, HEMISPHERICAL_RADIUS
from voxe_tpu_torch.viz.animations import render_camera_path_for_volumetric_model
from voxe_tpu_torch.viz.video import write_video


def _positive_int(text: str) -> int:
    """click.IntRange(min=1)."""
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"{value} is smaller than the minimum 1")
    return value


def add_path_flags(p: argparse.ArgumentParser, model_help: str) -> None:
    """The flags both render CLIs share, in the click commands' order."""
    a = p.add_argument
    a("-i", "--model_path", required=True, help=model_help)
    a("-o", "--output_path", required=True, help="path for saving rendered output")
    a("-r", "--ref_path", default=None, help="reference model whose camera metadata overrides this one's")
    a("-d", "--data_path", default=None, help="path to the input dataset (for camera_path=dataset)")
    a("--overridden_num_samples_per_ray", type=_positive_int, default=512)
    a("--render_scale_factor", type=float, default=2.0)
    a("--camera_path", choices=["thre360", "spiral", "dataset"], default="thre360")
    a("--camera_pitch", type=float, default=60.0)
    a("--num_frames", type=_positive_int, default=180)
    a("--vertical_camera_height", type=float, default=3.0)
    a("--num_spiral_rounds", type=_positive_int, default=2)
    a("--fps", type=_positive_int, default=60)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="render a camera-path video of a trained voxel grid (PyTorch port)")
    add_path_flags(p, "path to the trained (reconstructed) model")
    a = p.add_argument
    a("--save_freq", type=int, default=None, help="save every save_freq-th frame as a PNG")
    a("-p", "--sds_prompt", default=None, help="sds prompt; if given, written to prompt.txt")
    a("--use_shear_warp", type=_bool, default=False, help="frames through the shear-warp screen render")
    a("--device", default="cuda", help="torch device of the grid and the renders")
    return p


def camera_setup(config, extra_info) -> tuple:
    """(intrinsics, poses) of the chosen camera path; the intrinsics and the
    radius come from `--ref_path`'s checkpoint when it is given."""
    if config.ref_path is not None:
        _, extra_info = load_volumetric_model(Path(config.ref_path), device="cpu")
    radius = float(extra_info[HEMISPHERICAL_RADIUS])
    h, w, focal = extra_info[CAMERA_INTRINSICS]
    intrinsics = CameraIntrinsics(int(h), int(w), float(focal))
    if config.camera_path == "thre360":
        poses: List[CameraPose] = get_thre360_animation_poses(radius, config.camera_pitch, config.num_frames)
    elif config.camera_path == "spiral":
        poses = get_thre360_spiral_animation_poses(
            (radius / 8.0, radius), config.vertical_camera_height, config.num_spiral_rounds, config.num_frames
        )
    else:
        data_path = Path(config.data_path)
        dataset = PosedImagesDataset(
            images_dir=data_path / "train", camera_params_json=data_path / "train_camera_params.json",
            rgba_white_bkgd=True, device="cpu",
        )
        poses = [CameraPose(rotation=p[:, :3], translation=p[:, 3:]) for p in dataset.poses]
    return intrinsics, poses


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Render the path and write the video; returns the [T, H, W, 3] uint8
    frames."""
    config = build_parser().parse_args(argv)
    check_device(config.device)
    output_path = Path(config.output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    if config.sds_prompt is not None:
        (output_path / "prompt.txt").write_text(config.sds_prompt)
    vol_mod, extra_info = load_volumetric_model(Path(config.model_path), device=config.device)
    vol_mod.render_config = vol_mod.render_config.replace(white_bkgd=True)
    intrinsics, poses = camera_setup(config, extra_info)
    frames = render_camera_path_for_volumetric_model(
        vol_mod,
        poses,
        intrinsics,
        overridden_num_samples_per_ray=config.overridden_num_samples_per_ray,
        render_scale_factor=config.render_scale_factor,
        image_save_freq=config.save_freq,
        image_save_path=output_path,
        use_shear_warp=config.use_shear_warp,
    )
    write_video(output_path / "rendered_video.mp4", frames, fps=config.fps)
    return frames


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

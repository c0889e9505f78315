"""CLI: render attention turntable videos of a trained attention grid with
the PyTorch port (counterpart of render_sh_based_voxel_grid_attn.py: the same
flag names and defaults, parsed with argparse, plus `--device`).

    python -m voxe_tpu_torch.cli.render_sh_based_voxel_grid_attn \\
        -i refine/saved_models/model_final_attn_edit.pth -o render_attn \\
        [--use_shear_warp True] [--device cpu]

By default the grid's attention channel, jet-coloured and weighted by its
coverage, is blended over the RGB render (`--load_attention True` gives a
checkpoint without one a channel of -20). With `--use_sd True` each frame is
instead the exact render blended with SD's live cross-attention map of token
`--index_to_attn` for `--sds_prompt` (`--sd_weights_dir`: a local HF
snapshot; seeded random weights without it), with the draws from a
`torch.Generator` seeded 0. Writes `rendered_video.mp4` and every
`--save_freq`-th frame as `frame_<idx>.png`.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from voxe_tpu_torch.cli.render_sh_based_voxel_grid import add_path_flags, camera_setup
from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import _bool, check_device
from voxe_tpu_torch.models.volumetric import load_volumetric_model
from voxe_tpu_torch.utils.camera import scale_camera_intrinsics, to8b
from voxe_tpu_torch.viz.animations import (
    _exact_frames,
    live_sd_attention,
    render_camera_path_for_volumetric_model_attn_blend,
)
from voxe_tpu_torch.viz.video import write_video


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="render attention videos of a trained attention grid (PyTorch port)")
    add_path_flags(p, "path to the trained attn model")
    a = p.add_argument
    a("--timestamp", type=int, default=0, help="diffusion timestamp for live SD attention (0: drawn)")
    a("--use_sd", type=_bool, default=False, help="overlay live SD attention instead of the attn grid")
    a("--load_attention", type=_bool, default=True, help="load the checkpoint's attn channel")
    a("--sds_prompt", default="", help="prompt for live SD attention")
    a("--index_to_attn", type=int, default=11, help="token index for live SD attention")
    a("--save_freq", type=int, default=None, help="save every save_freq-th frame as PNG")
    a("--sd_weights_dir", default=None, help="local HF snapshot of the SD weights; seeded random without it")
    a("--sd_version", default="1.4", help="SD version for live attention")
    a("--use_shear_warp", type=_bool, default=False, help="frames through the shear-warp screen render")
    a("--device", default="cuda", help="torch device of the grid, SD and the renders")
    return p


def live_sd_frames(vol_mod, poses, intrinsics, config) -> np.ndarray:
    """Per pose: the exact render blended 0.55 / 0.45 with SD's attention
    map of one token on it, jet-coloured."""
    from voxe_tpu_torch.models.sd.sds import StableDiffusion

    sd = StableDiffusion(
        config.sd_version, weights_dir=Path(config.sd_weights_dir) if config.sd_weights_dir else None,
        device=config.device,
    )
    intr = scale_camera_intrinsics(intrinsics, config.render_scale_factor)
    generator = torch.Generator(device=config.device).manual_seed(0)

    def frame(pose):
        colour = vol_mod.render(intr, pose, num_samples_per_ray=config.overridden_num_samples_per_ray).colour
        rgb, attn_col = live_sd_attention(sd, config.sds_prompt, config.index_to_attn, colour, config.timestamp,
                                          generator)
        return to8b(0.55 * rgb + 0.45 * attn_col)

    return _exact_frames(poses, frame, vol_mod.grid.densities.device, "live SD attention")


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Render the path and write the video; returns the [T, H, W, 3] uint8
    frames."""
    config = build_parser().parse_args(argv)
    check_device(config.device)
    output_path = Path(config.output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    vol_mod, extra_info = load_volumetric_model(
        Path(config.model_path), device=config.device, with_attn=config.load_attention
    )
    vol_mod.render_config = vol_mod.render_config.replace(white_bkgd=True)
    intrinsics, poses = camera_setup(config, extra_info)
    if config.use_sd:
        frames = live_sd_frames(vol_mod, poses, intrinsics, config)
    else:
        frames = render_camera_path_for_volumetric_model_attn_blend(
            vol_mod,
            poses,
            intrinsics,
            overridden_num_samples_per_ray=config.overridden_num_samples_per_ray,
            render_scale_factor=config.render_scale_factor,
            use_shear_warp=config.use_shear_warp,
        )
    if config.save_freq is not None:
        for idx in range(0, len(frames), config.save_freq):
            Image.fromarray(frames[idx]).save(output_path / f"frame_{idx}.png")
    write_video(output_path / "rendered_video.mp4", frames, fps=config.fps)
    return frames


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

"""Synthetic posed-image scene (counterpart of voxe_tpu/data/synthetic.py).

A colourful three-blob grid rendered with the port's own exact renderer
from random hemisphere poses, written in the thre3d dataset layout
(images/ + {train,test}_camera_params.json) with Pillow, so the CLIs and the
chip smoke run on data the repo makes itself.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
from PIL import Image

from voxe_tpu_torch.data import constants as keys
from voxe_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    classify_view_direction,
    pose_spherical,
    to8b,
)

GOLDEN_HEMISPHERICAL_RADIUS = 4.031128406524658


def make_demo_grid(res: int = 48, world_size: float = 3.0, device="cuda"):
    """A colourful 3-blob scene as a VoxelGrid (softplus density field)."""
    from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize

    half = world_size / 2
    x = np.linspace(-half, half, res)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    blobs = [
        ((0.0, 0.0, -0.35), 0.75, (2.5, -1.5, -1.5)),  # red body
        ((0.0, 0.55, 0.45), 0.42, (-1.5, 2.5, -1.5)),  # green head
        ((0.45, -0.45, 0.1), 0.3, (-1.5, -1.5, 2.5)),  # blue limb
    ]
    density = np.full_like(X, -15.0)
    rgb = np.zeros((*X.shape, 3), dtype=np.float32)
    for (cx, cy, cz), radius, colour in blobs:
        inside = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2) < radius
        density = np.where(inside, 40.0, density)
        for c in range(3):
            rgb[..., c] = np.where(inside, colour[c], rgb[..., c])
    config = VoxelGridConfig(
        voxel_size=VoxelSize(*([world_size / res] * 3)),
        density_preactivation="identity",
        density_postactivation="softplus",
        expected_density_scale=1.0,
    )
    return VoxelGrid(
        torch.from_numpy(density[..., None].astype(np.float32)).to(device),
        torch.from_numpy(rgb).to(device),
        config,
    )


def generate_synthetic_scene(
    output_dir: Path,
    num_train: int = 12,
    num_test: int = 4,
    image_size: int = 64,
    focal: float = 64.0,
    radius: float = GOLDEN_HEMISPHERICAL_RADIUS,
    bounds: Tuple[float, float] = (2.0, 6.0),
    grid_res: int = 48,
    seed: int = 3,
    device="cuda",
    use_fused_kernel: bool = False,
) -> Path:
    """Render the demo grid from random hemisphere poses (pitch 15-85 deg)
    and write the dataset; returns the scene directory. `use_fused_kernel`
    composites through the CUDA kernel (the exact render's kernel route)."""
    from voxe_tpu_torch.models.volumetric import VolumetricModel
    from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig

    output_dir = Path(output_dir)
    images_dir = output_dir / "images"
    images_dir.mkdir(parents=True, exist_ok=True)
    render_config = SHVoxGridRenderConfig(
        num_samples_per_ray=192,
        camera_bounds=CameraBounds(*bounds),
        white_bkgd=True,
        render_num_samples_per_ray=192,
        parallel_rays_chunk_size=16384,
        use_fused_kernel=use_fused_kernel,
    )
    model = VolumetricModel(make_demo_grid(res=grid_res, device=device), render_config)
    intrinsics = CameraIntrinsics(image_size, image_size, focal)

    rng = np.random.default_rng(seed)
    split_params = {"train": {}, "test": {}}
    for split, count in (("train", num_train), ("test", num_test)):
        for i in range(count):
            pitch = 15.0 + float(rng.random()) * 70.0
            yaw = float(rng.random()) * 360.0
            pose = pose_spherical(yaw, pitch, radius)
            out = model.render(intrinsics, pose)
            name = f"{split}_{i:03d}.png"
            Image.fromarray(to8b(out.colour.cpu().numpy())).save(images_dir / name)
            split_params[split][name] = {
                keys.INTRINSIC: {
                    keys.BOUNDS: list(bounds),
                    keys.HEIGHT: image_size,
                    keys.WIDTH: image_size,
                    keys.FOCAL: focal,
                },
                keys.EXTRINSIC: {
                    keys.ROTATION: pose.rotation.tolist(),
                    keys.TRANSLATION: pose.translation.tolist(),
                },
                keys.DIRECTION: classify_view_direction(pitch, yaw),
            }
    for split in ("train", "test"):
        with open(output_dir / f"{split}_camera_params.json", "w") as f:
            json.dump(split_params[split], f, indent=4)
    return output_dir

"""Ray primitives and pinhole ray casting (counterpart of
voxe_tpu/render/rays.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from voxe_tpu_torch.utils.camera import CameraIntrinsics


class Rays(NamedTuple):
    origins: torch.Tensor  # [..., 3]
    directions: torch.Tensor  # [..., 3]


def flatten_rays(rays: Rays) -> Rays:
    return Rays(origins=rays.origins.reshape(-1, 3), directions=rays.directions.reshape(-1, 3))


def cast_rays(camera_intrinsics: CameraIntrinsics, rotation, translation, device=None) -> Rays:
    """Pinhole rays for one camera pose: pixel centres at +0.5, camera
    looking down -z with +y up. rotation [3, 3] camera-to-world,
    translation [3, 1]. Returns Rays of shape [H, W, 3] on `device` (default:
    the rotation's device, or the CPU for numpy input)."""
    rotation = torch.as_tensor(rotation, dtype=torch.float32, device=device)
    translation = torch.as_tensor(translation, dtype=torch.float32, device=rotation.device)
    height, width, focal = camera_intrinsics
    x = torch.linspace(0.5, width - 0.5, width, dtype=torch.float32, device=rotation.device)
    y = torch.linspace(0.5, height - 0.5, height, dtype=torch.float32, device=rotation.device)
    y_coords, x_coords = torch.meshgrid(y, x, indexing="ij")  # [H, W]
    dirs = torch.stack(
        [(x_coords - width * 0.5) / focal, -(y_coords - height * 0.5) / focal, -torch.ones_like(x_coords)],
        dim=-1,
    )
    rays_d = dirs @ rotation.T
    rays_o = translation.reshape(1, 1, 3).expand(rays_d.shape)
    return Rays(rays_o, rays_d)

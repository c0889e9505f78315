"""Ray primitives and pinhole ray casting (counterpart of
voxe_tpu/render/rays.py): one pose or a batch of poses, the NDC map, and
the synchronised ray/pixel subset."""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from voxe_tpu_torch.utils.camera import CameraIntrinsics


class Rays(NamedTuple):
    origins: torch.Tensor  # [..., 3]
    directions: torch.Tensor  # [..., 3]


def flatten_rays(rays: Rays) -> Rays:
    return Rays(origins=rays.origins.reshape(-1, 3), directions=rays.directions.reshape(-1, 3))


def collate_rays(rays_list: Sequence[Rays]) -> Rays:
    return Rays(
        origins=torch.cat([r.origins for r in rays_list], dim=0),
        directions=torch.cat([r.directions for r in rays_list], dim=0),
    )


def _camera_dirs(camera_intrinsics: CameraIntrinsics, device) -> torch.Tensor:
    """[H, W, 3] camera-frame directions through the pixel centres."""
    height, width, focal = camera_intrinsics
    x = torch.linspace(0.5, width - 0.5, width, dtype=torch.float32, device=device)
    y = torch.linspace(0.5, height - 0.5, height, dtype=torch.float32, device=device)
    y_coords, x_coords = torch.meshgrid(y, x, indexing="ij")  # [H, W]
    return torch.stack(
        [(x_coords - width * 0.5) / focal, -(y_coords - height * 0.5) / focal, -torch.ones_like(x_coords)],
        dim=-1,
    )


def cast_rays(camera_intrinsics: CameraIntrinsics, rotation, translation, device=None) -> Rays:
    """Pinhole rays for one camera pose: pixel centres at +0.5, camera
    looking down -z with +y up. rotation [3, 3] camera-to-world,
    translation [3, 1]. Returns Rays of shape [H, W, 3] on `device` (default:
    the rotation's device, or the CPU for numpy input)."""
    rotation = torch.as_tensor(rotation, dtype=torch.float32, device=device)
    translation = torch.as_tensor(translation, dtype=torch.float32, device=rotation.device)
    rays_d = _camera_dirs(camera_intrinsics, rotation.device) @ rotation.T
    rays_o = translation.reshape(1, 1, 3).expand(rays_d.shape)
    return Rays(rays_o, rays_d)


def cast_rays_batch(camera_intrinsics: CameraIntrinsics, rotations, translations, device=None) -> Rays:
    """`cast_rays` for a batch of poses: rotations [B, 3, 3], translations
    [B, 3, 1] -> Rays of shape [B, H, W, 3]."""
    rotations = torch.as_tensor(rotations, dtype=torch.float32, device=device)
    translations = torch.as_tensor(translations, dtype=torch.float32, device=rotations.device)
    rays_d = torch.einsum("hwc,bnc->bhwn", _camera_dirs(camera_intrinsics, rotations.device), rotations)
    rays_o = translations.reshape(-1, 1, 1, 3).expand(rays_d.shape)
    return Rays(rays_o, rays_d)


def ndcize_rays(rays: Rays, camera_intrinsics: CameraIntrinsics) -> Rays:
    """Map rays into NDC space (near plane at 1)."""
    height, width, focal = camera_intrinsics
    near = 1.0
    rays_o, rays_d = rays
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (width / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (height / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (width / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (height / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return Rays(torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1))


def select_rays_and_pixels(rays: Rays, pixels: torch.Tensor, indices) -> Tuple[Rays, torch.Tensor]:
    """The ray/pixel subset at flat `indices`, the same rows of both."""
    indices = torch.as_tensor(indices, device=pixels.device)
    return Rays(rays.origins[indices], rays.directions[indices]), pixels[indices]

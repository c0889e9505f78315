"""Camera types, spherical poses and the random hemisphere draw
(counterpart of voxe_tpu/utils/camera.py).

OpenGL-style camera (+x right, +y up, looking down -z); poses are built as
yaw @ pitch @ translate_z. Pose construction is tiny host math and stays in
NumPy. Two hemisphere draws: `get_random_pose` on a `np.random.Generator`
(the host draw of the editing loop, the same sequence as the JAX package's
for the same seed) and `random_pose`, the counterpart of `random_pose_jax`,
which draws pitch and yaw from an explicit `torch.Generator`. The camera
paths of the render CLIs (turntable and spiral) drop the last of
`num_poses` poses, as the reference does.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from voxe_tpu_torch.utils import tracing


class CameraIntrinsics(NamedTuple):
    height: int
    width: int
    focal: float


class CameraPose(NamedTuple):
    rotation: np.ndarray  # [3, 3] (numpy or torch)
    translation: np.ndarray  # [3, 1]


class CameraBounds(NamedTuple):
    near: float
    far: float


def _translate_z(z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = z
    return m


def _rotate_pitch(pitch: float) -> np.ndarray:
    c, s = np.cos(pitch), np.sin(pitch)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rotate_yaw(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def pose_spherical(yaw: float, pitch: float, radius: float) -> CameraPose:
    """Camera-to-world pose on a sphere (yaw/pitch in degrees)
    (reference: thre3d_atom/utils/imaging_utils.py:188-194)."""
    c2w = _translate_z(radius)
    c2w = _rotate_pitch(pitch / 180.0 * np.pi) @ c2w
    c2w = _rotate_yaw(yaw / 180.0 * np.pi) @ c2w
    return CameraPose(rotation=c2w[:3, :3], translation=c2w[:3, 3:])


def pose_from_angles(
    pitch_deg: torch.Tensor, yaw_deg: torch.Tensor, radius: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rotation [3, 3], translation [3, 1]) f32 tensors for a hemisphere
    pose given as 0-d angle tensors in degrees — `random_pose_jax`'s math."""
    pitch = pitch_deg * (math.pi / 180.0)
    yaw = yaw_deg * (math.pi / 180.0)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    one, zero = torch.ones_like(cp), torch.zeros_like(cp)
    rot_pitch = torch.stack(
        [torch.stack([one, zero, zero]), torch.stack([zero, cp, -sp]),
         torch.stack([zero, sp, cp])]
    )
    rot_yaw = torch.stack(
        [torch.stack([cy, -sy, zero]), torch.stack([sy, cy, zero]),
         torch.stack([zero, zero, one])]
    )
    rotation = rot_yaw @ rot_pitch
    translation = rotation @ tracing.upload(
        [[0.0], [0.0], [radius]], "draw.pose", dtype=rotation.dtype, device=rotation.device
    )
    return rotation, translation


def random_pose(
    generator: torch.Generator, radius: float, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random hemisphere pose: pitch ~ U[15, 90), yaw ~ U[0, 360).

    Returns (rotation [3, 3], translation [3, 1], pitch_deg, yaw_deg) on
    `device`; the draw comes from `generator` on its own device."""
    u = torch.rand(2, generator=generator, device=generator.device)
    pitch_deg = (15.0 + u[0] * 75.0).to(device)
    yaw_deg = (u[1] * 360.0).to(device)
    rotation, translation = pose_from_angles(pitch_deg, yaw_deg, radius)
    return rotation, translation, pitch_deg, yaw_deg


def direction_index(pitch_deg: float, yaw_deg: float) -> int:
    """View-direction bucket as an index into DIRECTION_PROMPTS
    (side=0, overhead=1, back=2, front=3; voxe_tpu/train/sds.py:495-501,
    reference imaging_utils.py:206-214)."""
    idx = 3
    if 45.0 < yaw_deg < 315.0:
        idx = 0
    if 120.0 < yaw_deg < 240.0:
        idx = 2
    if pitch_deg < 25.0:
        idx = 1
    return idx


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def to8b_tensor(x: torch.Tensor) -> torch.Tensor:
    """`to8b` on the tensor's device: clip to [0, 1], scale by 255 in f32 and
    truncate to uint8."""
    return (255.0 * torch.clamp(x.float(), 0.0, 1.0)).to(torch.uint8)


def scale_camera_intrinsics(camera_intrinsics: CameraIntrinsics, scale_factor: float = 1.0) -> CameraIntrinsics:
    """Height and width scaled and rounded up, focal scaled."""
    return CameraIntrinsics(
        height=int(np.ceil(camera_intrinsics.height * scale_factor)),
        width=int(np.ceil(camera_intrinsics.width * scale_factor)),
        focal=camera_intrinsics.focal * scale_factor,
    )


def get_thre360_animation_poses(hemispherical_radius: float, camera_pitch: float, num_poses: int) -> List[CameraPose]:
    """Turntable: constant pitch, yaw over linspace(0, 360, num_poses) without
    its last value (num_poses - 1 poses)."""
    return [
        pose_spherical(yaw, camera_pitch, hemispherical_radius)
        for yaw in np.linspace(0, 360, num_poses)[:-1]
    ]


def get_thre360_spiral_animation_poses(
    horizontal_radius_range: Tuple[float, float],
    vertical_camera_height: float,
    num_rounds: int,
    num_poses: int,
) -> List[CameraPose]:
    """Spiral: the horizontal radius grows over `horizontal_radius_range`
    while the yaw turns `num_rounds` times at a fixed camera height
    (num_poses - 1 poses)."""
    horizontal_radii = np.linspace(*horizontal_radius_range, num_poses)[:-1]
    radii = [np.sqrt(hr**2 + vertical_camera_height**2) for hr in horizontal_radii]
    yaws = np.linspace(0, 360 * num_rounds, num_poses)[:-1]
    pitches = [math.atan(hr / vertical_camera_height) * 180 / math.pi for hr in horizontal_radii]
    return [pose_spherical(yaw, pitch, radius) for yaw, pitch, radius in zip(yaws, pitches, radii)]


def adjust_dynamic_range(data, drange_in, drange_out, slack: bool = False):
    """Linearly remap `data` from `drange_in` to `drange_out`, clipped to the
    output range unless `slack` (then a pure affine map)."""
    if tuple(drange_in) == tuple(drange_out):
        return data
    scale = (np.float32(drange_out[1]) - np.float32(drange_out[0])) / (
        np.float32(drange_in[1]) - np.float32(drange_in[0])
    )
    if slack:
        bias = np.float32(drange_out[0]) - np.float32(drange_in[0]) * scale
        return data * scale + bias
    out = (data - np.float32(drange_in[0])) * scale + np.float32(drange_out[0])
    return out.clip(drange_out[0], drange_out[1])


def classify_view_direction(pitch_deg: float, yaw_deg: float) -> str:
    """Bucket a hemisphere pose into {front, side, back, overhead}."""
    return ("side", "overhead", "back", "front")[direction_index(pitch_deg, yaw_deg)]


def get_random_pose(
    radius: float, rng: Optional[np.random.Generator] = None
) -> Tuple[CameraPose, str, float, float]:
    """Random hemisphere pose on the host: pitch ~ U[15, 90), yaw ~ U[0, 360).
    Returns (pose, direction label, pitch_deg, yaw_deg)."""
    rng = rng if rng is not None else np.random.default_rng()
    rand_pitch = 15.0 + float(rng.random()) * 75.0
    rand_yaw = float(rng.random()) * 360.0
    pose = pose_spherical(rand_yaw, rand_pitch, radius)
    return pose, classify_view_direction(rand_pitch, rand_yaw), rand_pitch, rand_yaw

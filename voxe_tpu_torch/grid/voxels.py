"""Explicit SH voxel-grid scene representation
(counterpart of voxe_tpu/grid/voxels.py).

`VoxelGrid` is a small container of tensors — densities [X,Y,Z,1],
features [X,Y,Z,F], and for the refinement stage an optional attention
field attn [X,Y,Z,C] and a frozen copy of the densities, orig_densities
[X,Y,Z,1] — with a frozen `VoxelGridConfig`. Trainers hand the tensors they
train to a torch optimizer, which updates them in place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from voxe_tpu_torch.ops.trilinear import trilinear_interpolate


class VoxelSize(NamedTuple):
    """Per-axis voxel edge lengths (anisotropic voxels allowed)."""

    x_size: float = 1.0
    y_size: float = 1.0
    z_size: float = 1.0


class VoxelGridLocation(NamedTuple):
    """World-space location of the grid center (grid is axis-aligned)."""

    x_coord: float = 0.0
    y_coord: float = 0.0
    z_coord: float = 0.0


class AxisAlignedBoundingBox(NamedTuple):
    x_range: Tuple[float, float]
    y_range: Tuple[float, float]
    z_range: Tuple[float, float]


ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": F.relu,
    "abs": torch.abs,
    "softplus": F.softplus,
    "sigmoid": torch.sigmoid,
}


@dataclasses.dataclass(frozen=True)
class VoxelGridConfig:
    """Static grid configuration, activations by name (same fields and
    defaults as voxe_tpu's)."""

    voxel_size: VoxelSize = VoxelSize()
    grid_location: VoxelGridLocation = VoxelGridLocation()
    density_preactivation: str = "abs"
    density_postactivation: str = "identity"
    feature_preactivation: str = "identity"
    feature_postactivation: str = "identity"
    expected_density_scale: float = 1.0
    # dtype of the pre-activated table the renderer resamples; parameters and
    # gradients stay float32 either way
    gather_dtype: str = "float32"

    def to_json_dict(self):
        d = dataclasses.asdict(self)
        d["voxel_size"] = list(self.voxel_size)
        d["grid_location"] = list(self.grid_location)
        return d

    @staticmethod
    def from_json_dict(d) -> "VoxelGridConfig":
        d = dict(d)
        d["voxel_size"] = VoxelSize(*d["voxel_size"])
        d["grid_location"] = VoxelGridLocation(*d["grid_location"])
        return VoxelGridConfig(**d)


@dataclasses.dataclass
class VoxelGrid:
    densities: torch.Tensor  # [X, Y, Z, 1]
    features: torch.Tensor  # [X, Y, Z, F]
    config: VoxelGridConfig = VoxelGridConfig()
    attn: Optional[torch.Tensor] = None  # [X, Y, Z, C] attention logits
    orig_densities: Optional[torch.Tensor] = None  # [X, Y, Z, 1] frozen copy

    @property
    def grid_dims(self) -> Tuple[int, int, int]:
        return tuple(self.features.shape[:3])

    @property
    def aabb(self) -> AxisAlignedBoundingBox:
        """World-space AABB from the config and the shape (host floats)."""
        dims = self.grid_dims
        vs, loc = self.config.voxel_size, self.config.grid_location
        half = (dims[0] * vs.x_size / 2, dims[1] * vs.y_size / 2, dims[2] * vs.z_size / 2)
        return AxisAlignedBoundingBox(
            x_range=(loc.x_coord - half[0], loc.x_coord + half[0]),
            y_range=(loc.y_coord - half[1], loc.y_coord + half[1]),
            z_range=(loc.z_coord - half[2], loc.z_coord + half[2]),
        )

    def replace(self, **kwargs) -> "VoxelGrid":
        return dataclasses.replace(self, **kwargs)

    def with_frozen_orig_densities(self) -> "VoxelGrid":
        """Snapshot the current densities as the frozen reference copy."""
        return self.replace(orig_densities=self.densities.detach().clone())


def _aabb_tensors(aabb: AxisAlignedBoundingBox, like: torch.Tensor):
    mins = torch.tensor([aabb.x_range[0], aabb.y_range[0], aabb.z_range[0]], dtype=torch.float32, device=like.device)
    maxs = torch.tensor([aabb.x_range[1], aabb.y_range[1], aabb.z_range[1]], dtype=torch.float32, device=like.device)
    return mins, maxs


def _normalize_points(aabb: AxisAlignedBoundingBox, points: torch.Tensor) -> torch.Tensor:
    """Affine map of world points into [-1, 1]^3 of the grid (no clipping)."""
    mins, maxs = _aabb_tensors(aabb, points)
    scale = 2.0 / (maxs - mins)
    bias = -1.0 - mins * scale
    return points * scale + bias


def test_inside_volume(aabb: AxisAlignedBoundingBox, points: torch.Tensor) -> torch.Tensor:
    """[N, 1] bool: strictly inside the AABB."""
    return (
        (points[..., 0:1] > aabb.x_range[0])
        & (points[..., 0:1] < aabb.x_range[1])
        & (points[..., 1:2] > aabb.y_range[0])
        & (points[..., 1:2] < aabb.y_range[1])
        & (points[..., 2:3] > aabb.z_range[0])
        & (points[..., 2:3] < aabb.z_range[1])
    )



def grid_query(grid: VoxelGrid, points: torch.Tensor) -> torch.Tensor:
    """Interpolated [features..., density] at world points [N, 3]: the
    density pre-activation applies to raw * expected_density_scale before
    interpolation, the post-activations after."""
    return _query(grid, grid.features, grid.densities, points)


def grid_query_attn(grid: VoxelGrid, points: torch.Tensor, use_orig_densities: bool = False) -> torch.Tensor:
    """Interpolated [attn..., density] at world points [N, 3], the attention
    field taking the features' activations; with `use_orig_densities` the
    density comes from the frozen copy."""
    if grid.attn is None:
        raise ValueError("grid has no attn channel")
    if use_orig_densities and grid.orig_densities is None:
        raise ValueError("grid has no frozen orig_densities")
    return _query(grid, grid.attn, grid.orig_densities if use_orig_densities else grid.densities, points)


def _query(grid: VoxelGrid, features: torch.Tensor, densities: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    cfg = grid.config
    normalized = _normalize_points(grid.aabb, points)
    pre_density = ACTIVATIONS[cfg.density_preactivation](densities * cfg.expected_density_scale)
    pre_features = ACTIVATIONS[cfg.feature_preactivation](features)
    unified = torch.cat([pre_features, pre_density], dim=-1)
    if cfg.gather_dtype == "bfloat16":
        unified = unified.to(torch.bfloat16)
    interpolated = trilinear_interpolate(unified, normalized).float()
    feats = ACTIVATIONS[cfg.feature_postactivation](interpolated[..., :-1])
    dens = ACTIVATIONS[cfg.density_postactivation](interpolated[..., -1:])
    return torch.cat([feats, dens], dim=-1)


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of a half-pixel-centred linear resize whose
    triangle kernel widens by n_in / n_out when shrinking, normalised per
    output over the in-range taps (jax.image.resize's "linear" kernel)."""
    scale = n_out / n_in
    kscale = min(scale, 1.0)  # antialiased when shrinking
    x = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5  # source coords
    src = torch.arange(n_in, dtype=torch.float64)
    w = torch.clamp(1.0 - torch.abs((x[:, None] - src[None, :]) * kscale), min=0.0)
    w = w / w.sum(dim=1, keepdim=True)
    return w.to(torch.float32).to(device)


def resize_trilinear(unified: torch.Tensor, output_size: Tuple[int, int, int]) -> torch.Tensor:
    """[X, Y, Z, C] -> [*output_size, C], separable along the three axes
    (jax.image.resize's "trilinear")."""
    for axis in range(3):
        m = _resize_matrix(unified.shape[axis], int(output_size[axis]), unified.device)
        unified = torch.movedim(torch.tensordot(m, torch.movedim(unified, axis, 0), dims=1), 0, axis)
    return unified


def scale_voxel_grid(grid: VoxelGrid, output_size: Tuple[int, int, int], include_attn: bool = False) -> VoxelGrid:
    """Trilinearly resample the grid to `output_size`; the voxel size
    rescales so the world-space AABB is kept. With `include_attn` the first
    attention channel is resampled too (as in the JAX package); otherwise the
    result has no attention field."""
    channels = [grid.features, grid.densities]
    if include_attn:
        if grid.attn is None:
            raise ValueError("include_attn: grid has no attn channel")
        channels.append(grid.attn)
    unified = resize_trilinear(torch.cat(channels, dim=-1).float(), output_size)
    vs, dims = grid.config.voxel_size, grid.grid_dims
    new_voxel_size = VoxelSize(
        vs.x_size * dims[0] / output_size[0],
        vs.y_size * dims[1] / output_size[1],
        vs.z_size * dims[2] / output_size[2],
    )
    num_feat = grid.features.shape[-1]
    return VoxelGrid(
        densities=unified[..., num_feat : num_feat + 1].contiguous(),
        features=unified[..., :num_feat].contiguous(),
        config=dataclasses.replace(grid.config, voxel_size=new_voxel_size),
        attn=unified[..., num_feat + 1 : num_feat + 2].contiguous() if include_attn else None,
    )

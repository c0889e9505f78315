"""Explicit SH voxel-grid scene representation
(counterpart of voxe_tpu/grid/voxels.py).

`VoxelGrid` is a small container of tensors — densities [X,Y,Z,1] and
features [X,Y,Z,F] — with a frozen `VoxelGridConfig` (the attention
channels of the refinement stage come with that slice). Trainers hand
`densities`/`features` to a torch optimizer, which updates them in place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


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


@dataclasses.dataclass
class VoxelGrid:
    densities: torch.Tensor  # [X, Y, Z, 1]
    features: torch.Tensor  # [X, Y, Z, F]
    config: VoxelGridConfig = VoxelGridConfig()

    @property
    def grid_dims(self) -> Tuple[int, int, int]:
        return tuple(self.features.shape[:3])

    def replace(self, **kwargs) -> "VoxelGrid":
        return dataclasses.replace(self, **kwargs)

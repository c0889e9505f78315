"""Hybrid grid + MLP scene representation, the DVGO-style feature-voxel model
family (counterpart of voxe_tpu/grid/feature_voxels.py).

The grid stores abstract features; a small ReLU MLP head ("rgbnet") decodes
the interpolated features to radiance. A second head ("densitynet") exists
but applies only with `use_densitynet` (off by default, as in the reference,
whose forward comments it out). Neither package wires this model into a CLI.

`FeatureVoxelGrid` is a container of tensors — densities [X,Y,Z,1],
features [X,Y,Z,F] and each head as a list of (kernel [I,O], bias [O])
pairs — with a frozen config, in the style of `VoxelGrid`. `parameters()`
lists the tensors a torch optimizer trains. Checkpoints use the JAX
package's `fvg_*` npz keys and meta, so either package reads the other's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from voxe_tpu_torch.grid.voxels import (
    ACTIVATIONS,
    AxisAlignedBoundingBox,
    VoxelGridLocation,
    VoxelSize,
    _normalize_points,
    resize_trilinear,
)
from voxe_tpu_torch.ops.trilinear import trilinear_interpolate

MLPParams = List[Tuple[torch.Tensor, torch.Tensor]]  # [(kernel [I, O], bias [O])]


@dataclasses.dataclass(frozen=True)
class FeatureVoxelGridConfig:
    """Static configuration (same fields, defaults and JSON dict as
    voxe_tpu's): abs density pre-activation, identity otherwise, 64-wide
    4-deep heads, densitynet present but inert."""

    voxel_size: VoxelSize = VoxelSize()
    grid_location: VoxelGridLocation = VoxelGridLocation()
    density_preactivation: str = "abs"
    density_postactivation: str = "identity"
    feature_preactivation: str = "identity"
    feature_postactivation: str = "identity"
    expected_density_scale: float = 1.0
    rgbnet_width: int = 64
    rgbnet_depth: int = 4
    densitynet_width: int = 64
    densitynet_depth: int = 4
    use_densitynet: bool = False
    gather_dtype: str = "float32"

    def to_json_dict(self):
        d = dataclasses.asdict(self)
        d["voxel_size"] = list(self.voxel_size)
        d["grid_location"] = list(self.grid_location)
        return d

    @staticmethod
    def from_json_dict(d) -> "FeatureVoxelGridConfig":
        d = dict(d)
        d["voxel_size"] = VoxelSize(*d["voxel_size"])
        d["grid_location"] = VoxelGridLocation(*d["grid_location"])
        return FeatureVoxelGridConfig(**d)


def init_mlp_params(generator: torch.Generator, in_dim: int, width: int, depth: int, out_dim: int) -> MLPParams:
    """Kernels and hidden biases uniform in +-1/sqrt(fan_in) (torch
    nn.Linear's family), a zero final bias; drawn from `generator` on its
    device."""
    dims = [in_dim] + [width] * (depth - 1) + [out_dim]
    dev = generator.device
    params: MLPParams = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / math.sqrt(d_in)
        kernel = (torch.rand((d_in, d_out), generator=generator, device=dev) * 2 - 1) * bound
        if i == len(dims) - 2:
            bias = torch.zeros((d_out,), device=dev)
        else:
            bias = (torch.rand((d_out,), generator=generator, device=dev) * 2 - 1) * bound
        params.append((kernel, bias))
    return params


def apply_mlp(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP over the trailing axis: hidden layers ReLU, the last linear."""
    for i, (kernel, bias) in enumerate(params):
        x = x @ kernel + bias
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


@dataclasses.dataclass
class FeatureVoxelGrid:
    densities: torch.Tensor  # [X, Y, Z, 1]
    features: torch.Tensor  # [X, Y, Z, F]
    rgbnet: MLPParams
    densitynet: MLPParams
    config: FeatureVoxelGridConfig = FeatureVoxelGridConfig()

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

    def replace(self, **kwargs) -> "FeatureVoxelGrid":
        return dataclasses.replace(self, **kwargs)

    def parameters(self) -> List[torch.Tensor]:
        """Every trainable tensor: the grid's two, then both heads'."""
        return [self.densities, self.features] + [t for layer in self.rgbnet + self.densitynet for t in layer]


def create_feature_voxel_grid(
    generator: torch.Generator,
    grid_dims: Tuple[int, int, int],
    num_features: int,
    config: FeatureVoxelGridConfig = FeatureVoxelGridConfig(),
) -> FeatureVoxelGrid:
    """Densities uniform in [0, 1), features uniform in [-1, 1), fresh heads,
    all drawn from `generator` on its device."""
    dev = generator.device
    densities = torch.rand((*grid_dims, 1), generator=generator, device=dev)
    features = torch.rand((*grid_dims, num_features), generator=generator, device=dev) * 2 - 1
    rgbnet = init_mlp_params(generator, num_features, config.rgbnet_width, config.rgbnet_depth, 3)
    densitynet = init_mlp_params(generator, 1, config.densitynet_width, config.densitynet_depth, 1)
    return FeatureVoxelGrid(densities, features, rgbnet, densitynet, config)


def feature_grid_query(grid: FeatureVoxelGrid, points: torch.Tensor) -> torch.Tensor:
    """Interpolated and decoded [rgb..., density] at world points [N, 3]:
    the density pre-activation applies to raw * expected_density_scale
    before interpolation and the post-activation after; the features are
    pre-activated, interpolated, decoded by rgbnet and post-activated;
    densitynet applies only with `use_densitynet`."""
    cfg = grid.config
    normalized = _normalize_points(grid.aabb, points)
    pre_density = ACTIVATIONS[cfg.density_preactivation](grid.densities * cfg.expected_density_scale)
    pre_features = ACTIVATIONS[cfg.feature_preactivation](grid.features)
    unified = torch.cat([pre_features, pre_density], dim=-1)
    if cfg.gather_dtype == "bfloat16":
        unified = unified.to(torch.bfloat16)
    interpolated = trilinear_interpolate(unified, normalized).float()
    feats, dens = interpolated[..., :-1], interpolated[..., -1:]
    rgb = ACTIVATIONS[cfg.feature_postactivation](apply_mlp(grid.rgbnet, feats))
    if cfg.use_densitynet:
        dens = apply_mlp(grid.densitynet, dens)
    dens = ACTIVATIONS[cfg.density_postactivation](dens)
    return torch.cat([rgb, dens], dim=-1)


def scale_feature_voxel_grid(grid: FeatureVoxelGrid, output_size: Tuple[int, int, int]) -> FeatureVoxelGrid:
    """Trilinear resample of the grid (jax.image.resize's "trilinear", as
    `scale_voxel_grid` does it) keeping the world AABB; the heads carry over
    as they are (the same list)."""
    unified = resize_trilinear(torch.cat([grid.features, grid.densities], dim=-1).float(), output_size)
    vs, dims = grid.config.voxel_size, grid.grid_dims
    new_voxel_size = VoxelSize(
        vs.x_size * dims[0] / output_size[0],
        vs.y_size * dims[1] / output_size[1],
        vs.z_size * dims[2] / output_size[2],
    )
    num_feat = grid.features.shape[-1]
    return FeatureVoxelGrid(
        densities=unified[..., num_feat:].contiguous(),
        features=unified[..., :num_feat].contiguous(),
        rgbnet=grid.rgbnet,
        densitynet=grid.densitynet,
        config=dataclasses.replace(grid.config, voxel_size=new_voxel_size),
    )


def feature_grid_save_arrays(grid: FeatureVoxelGrid):
    """(arrays dict, meta dict) for an npz container, under the JAX
    package's `fvg_*` keys."""

    def host(t):
        return t.detach().cpu().numpy()

    arrays = {"fvg_densities": host(grid.densities), "fvg_features": host(grid.features)}
    for name, params in (("rgbnet", grid.rgbnet), ("densitynet", grid.densitynet)):
        for i, (kernel, bias) in enumerate(params):
            arrays[f"fvg_{name}_{i}_kernel"] = host(kernel)
            arrays[f"fvg_{name}_{i}_bias"] = host(bias)
    meta = {
        "config": grid.config.to_json_dict(),
        "rgbnet_layers": len(grid.rgbnet),
        "densitynet_layers": len(grid.densitynet),
    }
    return arrays, meta


def feature_grid_from_leaves(
    densities, features, rgbnet, densitynet, config: Mapping, device: Optional[torch.device] = None
) -> FeatureVoxelGrid:
    """A grid from host arrays: the leaves of a JAX `FeatureVoxelGrid` (its
    two grid arrays and its heads' (kernel, bias) pairs, anything
    `np.asarray` takes) and its config's JSON dict. The arrays are copied."""

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device or "cpu")

    return FeatureVoxelGrid(
        densities=tensor(densities),
        features=tensor(features),
        rgbnet=[(tensor(k), tensor(b)) for k, b in rgbnet],
        densitynet=[(tensor(k), tensor(b)) for k, b in densitynet],
        config=FeatureVoxelGridConfig.from_json_dict(config),
    )


def feature_grid_from_saved(arrays, meta, device: Optional[torch.device] = None) -> FeatureVoxelGrid:
    """The grid `feature_grid_save_arrays` (of either package) wrote."""

    def mlp(name: str, n: int):
        return [(arrays[f"fvg_{name}_{i}_kernel"], arrays[f"fvg_{name}_{i}_bias"]) for i in range(n)]

    return feature_grid_from_leaves(
        arrays["fvg_densities"], arrays["fvg_features"], mlp("rgbnet", meta["rgbnet_layers"]),
        mlp("densitynet", meta["densitynet_layers"]), meta["config"], device,
    )

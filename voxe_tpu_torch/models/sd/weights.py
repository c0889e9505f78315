"""Carry parameters across from the JAX package's layout
(counterpart of voxe_tpu/models/sd/weights.py for flax trees).

The port's submodules carry the flax module names, so the mapping is
mechanical: nested flax names join with "." and the leaves map as
  Dense `kernel` [in, out]         -> `weight` [out, in]
  Conv  `kernel` [kh, kw, in, out] -> `weight` [out, in, kh, kw]
  norm  `scale`                    -> `weight`
  Embed `embedding`                -> `weight`
  `bias`                           -> `bias`
Inputs are dicts of numpy arrays (e.g. `jax.tree_util.tree_map(np.asarray,
params)` on the JAX side); nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig


def _leaf(name: str, value: np.ndarray):
    value = np.asarray(value)
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    if name == "bias":
        return "bias", value
    raise KeyError(f"unknown flax leaf {name!r}")


def from_flax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> torch state_dict (float32 CPU
    tensors; `load_state_dict` casts them to the module's dtype/device)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + key + ".")
            else:
                name, arr = _leaf(key, value)
                out[prefix + name] = torch.from_numpy(
                    np.array(arr, dtype=np.float32, order="C")
                )

    walk(params, "")
    return out


def voxel_grid_from_numpy(
    densities: np.ndarray, features: np.ndarray, config: VoxelGridConfig, device="cuda"
) -> VoxelGrid:
    """A float32 VoxelGrid on `device` from numpy arrays."""
    def to(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return VoxelGrid(densities=to(densities), features=to(features), config=config)

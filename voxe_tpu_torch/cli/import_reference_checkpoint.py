"""CLI: convert a reference (PyTorch Vox-E) checkpoint into the port's
npz + JSON checkpoint (counterpart of tools/import_reference_checkpoint.py:
the same flags, parsed with argparse).

    python -m voxe_tpu_torch.cli.import_reference_checkpoint \\
        -i reference/model_final.pth -o model_final.pth [--density_postactivation softplus]

The reference torch-pickles its save-info dict INCLUDING live function and
class objects from thre3d_atom (reference volumetric_model.py:85-99), so a
plain torch.load needs the original package. This importer installs stub
modules for every `thre3d_atom.*` symbol the pickle references, loads the
tensors, and writes them with `VolumetricModel.save`, which either package
loads. The conversion runs on the host, as in the JAX tool.
"""
from __future__ import annotations

import argparse
import importlib.abc
import importlib.machinery
import sys
import types
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import _bool
from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelGridLocation, VoxelSize
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.utils.camera import CameraBounds


class _StubLoader(importlib.abc.Loader):
    def create_module(self, spec):
        mod = types.ModuleType(spec.name)
        mod.__path__ = []  # mark as package so submodule imports resolve

        def _getattr(name, _mod=spec.name):
            if name.startswith("__"):  # module protocol lookups (__file__, __spec__ ...) are not symbols
                raise AttributeError(name)
            # fabricate a maximally tolerant placeholder class: constructible
            # with any args, state-settable, subclass of tuple so NamedTuple
            # payloads (VoxelSize etc.) unpickle as plain tuples
            def __new__(cls, *a, **k):
                if len(a) == 1 and isinstance(a[0], (tuple, list)):
                    a = tuple(a[0])  # cls(iterable) pickling form
                if a and not k:
                    try:
                        return tuple.__new__(cls, a)
                    except TypeError:
                        pass
                return tuple.__new__(cls, ())

            cls = type(name, (tuple,), {"__module__": _mod, "__new__": __new__})
            setattr(mod, name, cls)
            return cls

        mod.__getattr__ = _getattr
        return mod

    def exec_module(self, module):
        pass


class _StubFinder(importlib.abc.MetaPathFinder):
    """Import hook fabricating any thre3d_atom.* module on demand so the
    reference's pickled class/function references resolve."""

    PREFIXES = ("thre3d_atom",)

    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in self.PREFIXES:
            return importlib.machinery.ModuleSpec(fullname, _StubLoader(), is_package=True)
        return None


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    a = p.add_argument
    a("-i", "--input_path", required=True, help="reference .pth checkpoint (torch pickle)")
    a("-o", "--output_path", required=True, help="output checkpoint path")
    a("--train_num_samples_per_ray", type=int, default=256)
    a("--render_num_samples_per_ray", type=int, default=512)
    a("--white_bkgd", type=_bool, default=True)
    a("--density_postactivation", choices=["softplus", "relu", "identity"], default="softplus",
      help="the activation the reference model was trained with (not recoverable from the pickle stubs)")
    return p


def import_reference_checkpoint(input_path: Path, output_path: Path, train_num_samples_per_ray: int = 256,
                                render_num_samples_per_ray: int = 512, white_bkgd: bool = True,
                                density_postactivation: str = "softplus") -> VolumetricModel:
    """Read the reference pickle under the stub finder (installed for the
    load only) and write the port's checkpoint; returns the model (on the
    CPU)."""
    finder = _StubFinder()
    sys.meta_path.insert(0, finder)
    try:
        payload = torch.load(input_path, map_location="cpu", weights_only=False)
    finally:  # the stub modules go with the finder
        sys.meta_path.remove(finder)
        for name in [m for m in sys.modules if m.split(".")[0] in _StubFinder.PREFIXES]:
            del sys.modules[name]

    state = payload["thre3d_repr"]["state_dict"]
    config = payload["thre3d_repr"]["config_dict"]
    extra = payload.get("extra_info", {})

    densities = _to_numpy(state["_densities"]).astype(np.float32)
    features = _to_numpy(state["_features"]).astype(np.float32)
    attn = _to_numpy(state["attn"]).astype(np.float32) if "attn" in state else None

    voxel_size = config.get("voxel_size")
    vs = tuple(float(v) for v in voxel_size) if voxel_size is not None else (3.0 / densities.shape[0],) * 3
    loc_obj = config.get("grid_location")
    loc = tuple(float(v) for v in loc_obj) if isinstance(loc_obj, tuple) else (0.0, 0.0, 0.0)
    expected_scale = float(config.get("expected_density_scale", 1.0))

    grid = VoxelGrid(
        densities=torch.from_numpy(densities),
        features=torch.from_numpy(features),
        attn=torch.from_numpy(attn) if attn is not None else None,
        config=VoxelGridConfig(
            voxel_size=VoxelSize(*vs),
            grid_location=VoxelGridLocation(*loc),
            density_preactivation="identity",
            density_postactivation=density_postactivation,
            expected_density_scale=expected_scale,
        ),
    )

    bounds = extra.get("camera_bounds")
    camera_bounds = (
        CameraBounds(float(bounds[0]), float(bounds[1])) if isinstance(bounds, (tuple, list))
        else CameraBounds(2.0 * 0.9, 6.0 * 1.1)
    )
    extra_info = {}
    for key in ("camera_bounds", "camera_intrinsics", "hemispherical_radius"):
        if key in extra:
            value = extra[key]
            extra_info[key] = [float(v) for v in value] if isinstance(value, (tuple, list)) else float(value)

    model = VolumetricModel(
        grid,
        SHVoxGridRenderConfig(
            num_samples_per_ray=train_num_samples_per_ray,
            camera_bounds=camera_bounds,
            white_bkgd=white_bkgd,
            render_num_samples_per_ray=render_num_samples_per_ray,
        ),
    )
    model.save(Path(output_path), extra_info=extra_info)
    return model


def main(argv: Optional[Sequence[str]] = None) -> VolumetricModel:
    config = build_parser().parse_args(argv)
    model = import_reference_checkpoint(
        Path(config.input_path), Path(config.output_path), config.train_num_samples_per_ray,
        config.render_num_samples_per_ray, config.white_bkgd, config.density_postactivation,
    )
    print(
        f"imported {config.input_path} -> {config.output_path} "
        f"(grid {model.grid.grid_dims}, attn={'yes' if model.grid.attn is not None else 'no'})"
    )
    return model


if __name__ == "__main__":
    main()

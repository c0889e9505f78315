"""The port's reference-checkpoint importer
(voxe_tpu_torch/cli/import_reference_checkpoint.py) against
tools/import_reference_checkpoint.py on the CPU: a reference-style torch
pickle, written while stub `thre3d_atom` modules stand in sys.modules
(NamedTuples for the grid's voxel size and location and the camera's
bounds and intrinsics, a function for the activation, all pickled by
reference), with and without an `attn` channel and an `extra_info`, goes
through both tools. The npz arrays must be bitwise equal and the JSON
metadata equal; both packages' loaders read the port's output."""
import json
import sys
import types
from typing import NamedTuple

import numpy as np
import pytest
import torch

from voxe_tpu_torch.cli import import_reference_checkpoint as tcli
from voxe_tpu_torch.models.volumetric import load_volumetric_model

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

RES = 10


class VoxelSize(NamedTuple):
    x_size: float
    y_size: float
    z_size: float


class VoxelGridLocation(NamedTuple):
    x_coord: float
    y_coord: float
    z_coord: float


class CameraBounds(NamedTuple):
    near: float
    far: float


class CameraIntrinsics(NamedTuple):
    height: int
    width: int
    focal: float


def _softplus(x):
    return torch.nn.functional.softplus(x)


def _forget_thre3d_atom():
    """Drop every thre3d_atom module and stub finder from this process."""
    for name in [m for m in sys.modules if m.split(".")[0] == "thre3d_atom"]:
        del sys.modules[name]
    sys.meta_path[:] = [f for f in sys.meta_path if type(f).__name__ != "_StubFinder"]


def write_reference_pickle(path, with_attn: bool, with_extra: bool) -> None:
    """A reference Vox-E save-info dict (reference volumetric_model.py:85-99)
    pickled while stub thre3d_atom modules hold its classes and function."""
    voxels = types.ModuleType("thre3d_atom.thre3d_reprs.voxels")
    imaging = types.ModuleType("thre3d_atom.utils.imaging_utils")
    stubs = {"thre3d_atom": types.ModuleType("thre3d_atom"),
             "thre3d_atom.thre3d_reprs": types.ModuleType("thre3d_atom.thre3d_reprs"),
             "thre3d_atom.utils": types.ModuleType("thre3d_atom.utils"),
             voxels.__name__: voxels, imaging.__name__: imaging}
    saved = {}
    for module, objs in ((voxels, (VoxelSize, VoxelGridLocation, _softplus)),
                         (imaging, (CameraBounds, CameraIntrinsics))):
        for obj in objs:
            saved[obj] = (obj.__module__, obj.__qualname__)
            obj.__module__, obj.__qualname__ = module.__name__, obj.__name__.lstrip("_")
            setattr(module, obj.__qualname__, obj)
    rng = np.random.default_rng(3)
    state = {"_densities": torch.from_numpy(rng.standard_normal((RES, RES, RES, 1)).astype(np.float32)),
             "_features": torch.from_numpy(rng.standard_normal((RES, RES, RES, 3)).astype(np.float32))}
    if with_attn:
        state["attn"] = torch.from_numpy(rng.standard_normal((RES, RES, RES, 1)).astype(np.float32))
    payload = {"thre3d_repr": {"state_dict": state, "config_dict": {
        "grid_dims": (RES, RES, RES), "feature_dims": 3, "voxel_size": VoxelSize(0.3, 0.3, 0.3),
        "grid_location": VoxelGridLocation(0.1, -0.2, 0.0), "density_preactivation": torch.abs,
        "density_postactivation": _softplus, "expected_density_scale": 2.5}}}
    if with_extra:
        payload["extra_info"] = {"camera_bounds": CameraBounds(2.5, 7.25),
                                 "camera_intrinsics": CameraIntrinsics(400, 400, 555.5),
                                 "hemispherical_radius": 4.0311, "scene_name": "dog2"}
    sys.modules.update(stubs)
    try:
        torch.save(payload, path)
    finally:
        for name in stubs:
            del sys.modules[name]
        for obj, (module, qualname) in saved.items():
            obj.__module__, obj.__qualname__ = module, qualname


def _read(path):
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: np.array(data[k]) for k in data.files if k != "__meta__"}
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    return arrays, meta


@pytest.mark.parametrize("with_attn", [False, True], ids=["no_attn", "attn"])
@pytest.mark.parametrize("with_extra", [False, True], ids=["no_extra", "extra"])
def test_import_matches_jax_tool(tmp_path, with_attn, with_extra):
    from click.testing import CliRunner

    from tools.import_reference_checkpoint import main as jmain
    from voxe_tpu.models.volumetric import load_volumetric_model as jload

    ref = tmp_path / "reference.pth"
    write_reference_pickle(ref, with_attn, with_extra)
    assert "thre3d_atom" not in sys.modules
    flags = ["--train_num_samples_per_ray", "128", "--white_bkgd", "False"]
    try:
        model = tcli.main(["-i", str(ref), "-o", str(tmp_path / "port.pth"), *flags])
        assert not any(type(f).__name__ == "_StubFinder" for f in sys.meta_path)  # the port's finder is gone
        _forget_thre3d_atom()
        res = CliRunner().invoke(jmain, ["-i", str(ref), "-o", str(tmp_path / "jax.pth"), *flags],
                                 catch_exceptions=False)
        assert res.exit_code == 0, res.output
    finally:
        _forget_thre3d_atom()
    assert model.grid.grid_dims == (RES,) * 3 and (model.grid.attn is not None) == with_attn

    got, got_meta = _read(tmp_path / "port.pth")
    want, want_meta = _read(tmp_path / "jax.pth")
    assert sorted(got) == sorted(want) == sorted(["_densities", "_features"] + (["_attn"] if with_attn else []))
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), name
    assert got_meta == want_meta
    assert got_meta["grid_config"]["expected_density_scale"] == 2.5
    assert got_meta["grid_config"]["grid_location"] == pytest.approx([0.1, -0.2, 0.0])
    assert got_meta["render_config"]["camera_bounds"] == ([2.5, 7.25] if with_extra else pytest.approx([1.8, 6.6]))

    tmodel, textra = load_volumetric_model(tmp_path / "port.pth", device="cpu")
    jmodel, jextra = jload(tmp_path / "port.pth")
    assert textra == jextra == ({"camera_bounds": [2.5, 7.25], "camera_intrinsics": [400.0, 400.0, 555.5],
                                 "hemispherical_radius": 4.0311} if with_extra else {})
    for name in ("densities", "features") + (("attn",) if with_attn else ()):
        np.testing.assert_array_equal(getattr(tmodel.grid, name).numpy(), np.asarray(getattr(jmodel.grid, name)))

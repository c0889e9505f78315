"""VolumetricModel: voxel grid + render configuration + checkpoint IO
(counterpart of voxe_tpu/models/volumetric.py).

Checkpoints use the JAX package's layout exactly: one npz archive holding
`_densities` / `_features` (and, for the refinement stage's grids, `_attn` /
`_orig_densities`) as float32 arrays and a `__meta__` JSON document (format
"voxe_tpu.volumetric_model.v1": grid config, render config, extra info), so
a grid saved by either package loads in the other.

The full-image render is the exact renderer in a Python loop over fixed
chunks of `parallel_rays_chunk_size` rays, the last chunk padded with
zero rays (as the JAX `lax.map` does), under `torch.no_grad()`; with
`use_shear_warp=True` it is the shear-warp screen render instead, except for
a camera inside the grid's AABB along its marching axis, which the
factorization cannot render: that pose goes to the exact renderer, with a
warning, as in the JAX package. `attn=True` renders the attention field
instead of the colour, on either path.

The camera-path renders (`render_camera_path_fast[_attn]`) take every frame
of a path through the shear-warp screen render in a no-grad loop over the
poses on the grid's device, turn each into uint8 there (`to8b`'s
truncation) and stack them (`utils/timing.py::render_frames`, which logs
the frames' times); they refuse the whole path when one pose sits inside
the grid's AABB.
"""
from __future__ import annotations

import dataclasses
import io
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig
from voxe_tpu_torch.render.accumulate import RenderOut
from voxe_tpu_torch.render.interface import (
    SHVoxGridRenderConfig,
    render_sh_voxel_grid,
    render_sh_voxel_grid_attn,
)
from voxe_tpu_torch.render.rays import Rays, cast_rays, flatten_rays
from voxe_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, CameraPose, to8b_tensor
from voxe_tpu_torch.utils.constants import EXTRA_ACCUMULATED_WEIGHTS
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.timing import render_frames

FORMAT = "voxe_tpu.volumetric_model.v1"
EXTRA_INFO = "extra_info"


class VolumetricModel:
    """A VoxelGrid and its render configuration."""

    def __init__(
        self,
        grid: VoxelGrid,
        render_config: SHVoxGridRenderConfig,
        extra_info: Optional[Dict[str, Any]] = None,
    ):
        self.grid = grid
        self.render_config = render_config
        self.extra_info = dict(extra_info or {})

    def render_rays(
        self,
        rays: Rays,
        generator: Optional[torch.Generator] = None,
        **config_overrides,
    ) -> RenderOut:
        """Differentiable render of flat rays (the train-time path)."""
        cfg = self.render_config.replace(**config_overrides) if config_overrides else self.render_config
        return render_sh_voxel_grid(self.grid, rays, cfg, generator=generator)

    def render_rays_attn(
        self,
        rays: Rays,
        generator: Optional[torch.Generator] = None,
        use_orig_densities: bool = False,
        **config_overrides,
    ) -> RenderOut:
        """Differentiable render of the attention field along flat rays."""
        cfg = self.render_config.replace(**config_overrides) if config_overrides else self.render_config
        return render_sh_voxel_grid_attn(self.grid, rays, cfg, generator=generator, use_orig_densities=use_orig_densities)

    @torch.no_grad()
    def render(
        self,
        camera_intrinsics: CameraIntrinsics,
        pose: CameraPose,
        attn: bool = False,
        use_orig_densities: bool = False,
        **config_overrides,
    ) -> RenderOut:
        """Full image with the exact renderer: no jitter, AABB-bounded
        sampling and `render_num_samples_per_ray` samples unless overridden.
        `use_shear_warp=True` takes the shear-warp screen render instead
        (`shear_warp_base_res` overrides its square base side, by default
        twice the screen's long side). `attn` renders the attention field
        (over the frozen densities with `use_orig_densities`). Returns
        RenderOut with [H, W, C] leaves on the grid's device."""
        use_shear_warp = config_overrides.pop("use_shear_warp", False)
        shear_warp_base_res = config_overrides.pop("shear_warp_base_res", None)
        if use_shear_warp:
            from voxe_tpu_torch.render.shearwarp import render_shear_warp_to_screen, shear_warp_supports_pose

            if shear_warp_supports_pose(self.grid, pose):
                # sampling options do not apply: the quadrature is the grid's own slices
                cfg = self.render_config.replace(
                    perturb_sampled_points=False, stochastic_density_noise_std=0.0,
                    **{k: v for k, v in config_overrides.items()
                       if k not in ("optimized_sampling", "num_samples_per_ray")},
                )
                base_hw = (int(shear_warp_base_res),) * 2 if shear_warp_base_res else None
                return render_shear_warp_to_screen(
                    self.grid, pose, camera_intrinsics, cfg, base_hw=base_hw,
                    attn_mode=attn, use_orig_densities=use_orig_densities,
                )
            log.warning(
                "shear-warp render: camera is inside the grid AABB along its marching axis — "
                "rendering this pose with the exact renderer"
            )
        cfg = self.render_config.replace(
            perturb_sampled_points=False,
            optimized_sampling=config_overrides.pop("optimized_sampling", True),
            num_samples_per_ray=config_overrides.pop(
                "num_samples_per_ray", self.render_config.render_num_samples_per_ray
            ),
            stochastic_density_noise_std=0.0,
            **config_overrides,
        )
        dev = self.grid.densities.device
        rays = flatten_rays(cast_rays(camera_intrinsics, pose.rotation, pose.translation, device=dev))
        height, width = camera_intrinsics.height, camera_intrinsics.width
        out = _chunked_render(self.grid, rays, cfg, height * width, attn, use_orig_densities)
        reshape = lambda t: t.reshape(height, width, -1)
        return RenderOut(
            colour=reshape(out.colour),
            depth=reshape(out.depth),
            extra={k: reshape(v) for k, v in out.extra.items()},
        )

    def _fast_path_config(self, poses) -> SHVoxGridRenderConfig:
        """The deterministic preview config of the camera-path renders,
        after checking every pose: one pose inside the volume refuses the
        whole path (no per-frame fallback)."""
        from voxe_tpu_torch.render.shearwarp import _host_f32, check_shear_warp_poses

        check_shear_warp_poses(
            self.grid,
            np.stack([np.concatenate([_host_f32(p.rotation), _host_f32(p.translation).reshape(3, 1)], 1)
                      for p in poses]),
            "fast camera-path render",
        )
        return self.render_config.replace(perturb_sampled_points=False, stochastic_density_noise_std=0.0)

    @torch.no_grad()
    def render_camera_path_fast(self, camera_intrinsics: CameraIntrinsics, poses) -> np.ndarray:
        """Every frame of a camera path through the shear-warp screen render
        (its default base lattice). Returns [T, H, W, 3] uint8."""
        from voxe_tpu_torch.render.shearwarp import render_shear_warp_to_screen

        cfg = self._fast_path_config(poses)

        def one(pose):
            return (to8b_tensor(render_shear_warp_to_screen(self.grid, pose, camera_intrinsics, cfg).colour),)

        return render_frames(poses, one, self.grid.densities.device, "shear-warp")[0]

    @torch.no_grad()
    def render_camera_path_fast_attn(
        self, camera_intrinsics: CameraIntrinsics, poses, include_rgb: bool = True
    ) -> Tuple[Optional[np.ndarray], np.ndarray, np.ndarray]:
        """RGB, attention and attention-coverage frames of a camera path
        through the shear-warp screen render: ([T, H, W, 3] uint8 or None,
        [T, H, W] uint8, [T, H, W] uint8), attention and coverage clipped to
        [0, 1] and scaled to 0..255. `include_rgb=False` skips the RGB
        render."""
        from voxe_tpu_torch.render.shearwarp import render_shear_warp_to_screen

        cfg = self._fast_path_config(poses)

        def one(pose):
            out = render_shear_warp_to_screen(self.grid, pose, camera_intrinsics, cfg, attn_mode=True)
            attn = (to8b_tensor(out.colour[..., 0]), to8b_tensor(out.extra[EXTRA_ACCUMULATED_WEIGHTS][..., 0]))
            if not include_rgb:
                return attn
            rgb = render_shear_warp_to_screen(self.grid, pose, camera_intrinsics, cfg).colour
            return (to8b_tensor(rgb),) + attn

        frames = render_frames(poses, one, self.grid.densities.device, "shear-warp attention")
        return tuple(frames) if include_rgb else (None, *frames)

    def save(self, path: Path, extra_info: Optional[Dict[str, Any]] = None) -> None:
        save_volumetric_model(self, Path(path), extra_info)


def _chunked_render(
    grid: VoxelGrid, rays: Rays, config: SHVoxGridRenderConfig, num_rays: int,
    attn: bool = False, use_orig_densities: bool = False,
) -> RenderOut:
    chunk = min(config.parallel_rays_chunk_size, num_rays)
    num_chunks = -(-num_rays // chunk)
    padded = num_chunks * chunk

    def pad(x):
        return torch.cat([x, x.new_zeros((padded - num_rays, x.shape[-1]))], dim=0)

    origins, directions = pad(rays.origins.contiguous()), pad(rays.directions.contiguous())
    def render(r):
        if attn:
            return render_sh_voxel_grid_attn(grid, r, config, use_orig_densities=use_orig_densities)
        return render_sh_voxel_grid(grid, r, config)

    outs = [render(Rays(origins[i : i + chunk], directions[i : i + chunk])) for i in range(0, padded, chunk)]
    cat = lambda ts: torch.cat(ts, dim=0)[:num_rays]
    return RenderOut(
        colour=cat([o.colour for o in outs]),
        depth=cat([o.depth for o in outs]),
        extra={k: cat([o.extra[k] for o in outs]) for k in outs[0].extra},
    )


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return np.asarray(obj.detach().cpu() if isinstance(obj, torch.Tensor) else obj).tolist()
    return obj


def save_volumetric_model(
    model: VolumetricModel, path: Path, extra_info: Optional[Dict[str, Any]] = None
) -> None:
    """Write the npz + JSON checkpoint (any file extension)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    grid = model.grid
    arrays = {
        "_densities": grid.densities.detach().to("cpu", torch.float32).numpy(),
        "_features": grid.features.detach().to("cpu", torch.float32).numpy(),
    }
    for name in ("attn", "orig_densities"):
        t = getattr(grid, name)
        if t is not None:
            arrays[f"_{name}"] = t.detach().to("cpu", torch.float32).numpy()
    info = dict(model.extra_info)
    info.update(extra_info or {})
    render_cfg = dataclasses.asdict(model.render_config)
    render_cfg["camera_bounds"] = [float(v) for v in model.render_config.camera_bounds]
    meta = {
        "format": FORMAT,
        "grid_config": grid.config.to_json_dict(),
        "render_config": render_cfg,
        EXTRA_INFO: _jsonify(info),
    }
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    path.write_bytes(buf.getvalue())


def load_volumetric_model(
    path: Path, device="cuda", with_attn: bool = False
) -> Tuple[VolumetricModel, Dict[str, Any]]:
    """Load a checkpoint written by either package onto `device`, with its
    attention field and frozen densities when it has them. `with_attn` gives
    a checkpoint without an attention field one channel of -20 (the JAX
    package's injection). Returns (model, extra_info)."""
    def read(data, name):
        if name not in data:
            return None
        return torch.from_numpy(np.array(data[name], np.float32)).to(device)

    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        densities, features = read(data, "_densities"), read(data, "_features")
        attn, orig = read(data, "_attn"), read(data, "_orig_densities")
    if with_attn and attn is None:
        attn = torch.full_like(densities, -20.0)
    grid = VoxelGrid(
        densities, features, VoxelGridConfig.from_json_dict(meta["grid_config"]), attn=attn, orig_densities=orig
    )
    rc = dict(meta["render_config"])
    rc["camera_bounds"] = CameraBounds(*[float(v) for v in rc["camera_bounds"]])
    extra_info = meta.get(EXTRA_INFO, {})
    return VolumetricModel(grid, SHVoxGridRenderConfig(**rc), extra_info), extra_info

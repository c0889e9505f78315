"""Camera-path (turntable, spiral, dataset-path) frame renders of a
volumetric model (counterpart of voxe_tpu/viz/animations.py).

Each function returns [T, H, W, 3] uint8 frames. The exact route renders
a frame at a time with `VolumetricModel.render` and turns it into uint8 on
the grid's device; `use_shear_warp` takes the whole path through
`render_camera_path_fast[_attn]`. Both routes run the frame loop of
`utils/timing.py::render_frames`. Attention is coloured with matplotlib's
jet carried as data (`_jet.py`) and blended on the host in float64, as the
JAX package does; PNG frames are written with Pillow.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from voxe_tpu_torch.utils.camera import CameraIntrinsics, CameraPose, scale_camera_intrinsics, to8b, to8b_tensor
from voxe_tpu_torch.utils.constants import EXTRA_ACCUMULATED_WEIGHTS
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.timing import render_frames
from voxe_tpu_torch.viz._jet import JET_256
from voxe_tpu_torch.viz.static import _colormap


def _jet(x: np.ndarray) -> np.ndarray:
    """matplotlib.colormaps["jet"](x)[..., :3] for float x."""
    return _colormap(JET_256, x)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _setup(camera_intrinsics, overridden_num_samples_per_ray, render_scale_factor):
    if render_scale_factor is not None:
        camera_intrinsics = scale_camera_intrinsics(camera_intrinsics, render_scale_factor)
    overrides = {}
    if overridden_num_samples_per_ray is not None:
        overrides["num_samples_per_ray"] = overridden_num_samples_per_ray
    return camera_intrinsics, overrides


BLEND_ALPHA = 0.45  # the attention's share in the blend over the RGB render


def _exact_frames(camera_path, render_frame, device, what: str) -> np.ndarray:
    """`render_frame(pose)` -> one frame, for each pose, stacked on the host."""
    return render_frames(camera_path, lambda pose: (render_frame(pose),), device, f"exact {what}")[0]


def render_camera_path_for_volumetric_model(
    vol_mod,
    camera_path: Sequence[CameraPose],
    camera_intrinsics: CameraIntrinsics,
    overridden_num_samples_per_ray: Optional[int] = None,
    render_scale_factor: Optional[float] = None,
    image_save_freq: Optional[int] = None,
    image_save_path: Optional[Path] = None,
    use_shear_warp: bool = False,
) -> np.ndarray:
    """RGB frames along a camera path, kept on the device until the last
    one is done; every `image_save_freq`-th frame also goes to
    `image_save_path/frame_<idx>.png`."""
    camera_intrinsics, overrides = _setup(camera_intrinsics, overridden_num_samples_per_ray, render_scale_factor)
    if use_shear_warp:
        log.info(f"rendering all {len(camera_path)} frames through the shear-warp screen render")
        frames = vol_mod.render_camera_path_fast(camera_intrinsics, camera_path)
    else:
        frames = _exact_frames(
            camera_path, lambda pose: to8b_tensor(vol_mod.render(camera_intrinsics, pose, **overrides).colour),
            vol_mod.grid.densities.device, "colour",
        )
    if image_save_freq is not None and image_save_path is not None:
        Path(image_save_path).mkdir(parents=True, exist_ok=True)
        for idx in range(0, frames.shape[0], image_save_freq):
            Image.fromarray(frames[idx]).save(Path(image_save_path) / f"frame_{idx}.png")
    return frames


def render_camera_path_for_volumetric_model_attn(
    vol_mod,
    camera_path: Sequence[CameraPose],
    camera_intrinsics: CameraIntrinsics,
    overridden_num_samples_per_ray: Optional[int] = None,
    render_scale_factor: Optional[float] = None,
    use_shear_warp: bool = False,
) -> np.ndarray:
    """RGB | jet-coloured attention, side by side."""
    camera_intrinsics, overrides = _setup(camera_intrinsics, overridden_num_samples_per_ray, render_scale_factor)
    if use_shear_warp:
        rgb_u8, attn_u8, _ = vol_mod.render_camera_path_fast_attn(camera_intrinsics, camera_path)
        return np.stack([
            np.concatenate([rgb_u8[i], to8b(_jet(attn_u8[i].astype(np.float32) / 255.0))], axis=1)
            for i in range(rgb_u8.shape[0])
        ])

    def frame(pose):
        rgb = _host(vol_mod.render(camera_intrinsics, pose, **overrides).colour)
        attn = _host(vol_mod.render(camera_intrinsics, pose, attn=True, **overrides).colour)[..., 0]
        return np.concatenate([to8b(rgb), to8b(_jet(np.clip(attn, 0.0, 1.0)))], axis=1)

    return _exact_frames(camera_path, frame, vol_mod.grid.densities.device, "attention")


def render_camera_path_for_volumetric_model_attn_only(
    vol_mod,
    camera_path: Sequence[CameraPose],
    camera_intrinsics: CameraIntrinsics,
    overridden_num_samples_per_ray: Optional[int] = None,
    render_scale_factor: Optional[float] = None,
    use_shear_warp: bool = False,
) -> np.ndarray:
    """Jet-coloured attention frames (no RGB render on the shear-warp route)."""
    camera_intrinsics, overrides = _setup(camera_intrinsics, overridden_num_samples_per_ray, render_scale_factor)
    if use_shear_warp:
        _, attn_u8, _ = vol_mod.render_camera_path_fast_attn(camera_intrinsics, camera_path, include_rgb=False)
        return np.stack([to8b(_jet(a.astype(np.float32) / 255.0)) for a in attn_u8])

    def frame(pose):
        attn = _host(vol_mod.render(camera_intrinsics, pose, attn=True, **overrides).colour)[..., 0]
        return to8b(_jet(np.clip(attn, 0.0, 1.0)))

    return _exact_frames(camera_path, frame, vol_mod.grid.densities.device, "attention-only")


def live_sd_attention(sd_model, prompt: str, token_index: int, colour: torch.Tensor, timestamp: int,
                      generator: Optional[torch.Generator] = None):
    """(RGB, jet-coloured attention), both [H, W, 3] on the host: SD's
    attention map of token `token_index` on the rendered `colour` (one
    noised capture-UNet pass, `StableDiffusion.get_attn_map`, draws from
    `generator`; t drawn when `timestamp` is 0), normalised."""
    from voxe_tpu_torch.models.sd.cross_attn import normalize_attn_map

    maps, _ = sd_model.get_attn_map(prompt, colour[None], timestamp=timestamp, indices_to_fetch=[token_index],
                                    generator=generator)
    return _host(colour), _jet(_host(normalize_attn_map(maps[0])))


def render_camera_path_for_volumetric_model_gt_attn_maps(
    vol_mod,
    camera_path: Sequence[CameraPose],
    camera_intrinsics: CameraIntrinsics,
    sd_model,
    prompt: str,
    token_index: int,
    generator: Optional[torch.Generator] = None,
    timestamp: int = 200,
    overridden_num_samples_per_ray: Optional[int] = None,
    render_scale_factor: Optional[float] = None,
) -> np.ndarray:
    """RGB | live SD attention of token `token_index`, side by side (the
    exact render, then `live_sd_attention` on it)."""
    camera_intrinsics, overrides = _setup(camera_intrinsics, overridden_num_samples_per_ray, render_scale_factor)

    def frame(pose):
        colour = vol_mod.render(camera_intrinsics, pose, **overrides).colour
        rgb, attn_col = live_sd_attention(sd_model, prompt, token_index, colour, timestamp, generator)
        return np.concatenate([to8b(rgb), to8b(attn_col)], axis=1)

    return _exact_frames(camera_path, frame, vol_mod.grid.densities.device, "live SD attention")


def render_camera_path_for_volumetric_model_attn_blend(
    vol_mod,
    camera_path: Sequence[CameraPose],
    camera_intrinsics: CameraIntrinsics,
    overridden_num_samples_per_ray: Optional[int] = None,
    render_scale_factor: Optional[float] = None,
    use_shear_warp: bool = False,
) -> np.ndarray:
    """Jet-coloured attention, weighted by its coverage, blended over the
    RGB render."""
    camera_intrinsics, overrides = _setup(camera_intrinsics, overridden_num_samples_per_ray, render_scale_factor)
    if use_shear_warp:
        rgb_u8, attn_u8, acc_u8 = vol_mod.render_camera_path_fast_attn(camera_intrinsics, camera_path)
        frames = []
        for i in range(rgb_u8.shape[0]):
            rgb = rgb_u8[i].astype(np.float32) / 255.0
            acc = (acc_u8[i].astype(np.float32) / 255.0)[..., None]
            attn_col = _jet(attn_u8[i].astype(np.float32) / 255.0)
            frames.append(to8b((1.0 - BLEND_ALPHA) * rgb + BLEND_ALPHA * attn_col * acc))
        return np.stack(frames)

    def frame(pose):
        rgb = _host(vol_mod.render(camera_intrinsics, pose, **overrides).colour)
        out_attn = vol_mod.render(camera_intrinsics, pose, attn=True, **overrides)
        acc = _host(out_attn.extra[EXTRA_ACCUMULATED_WEIGHTS])
        attn_col = _jet(np.clip(_host(out_attn.colour)[..., 0], 0.0, 1.0))
        return to8b((1.0 - BLEND_ALPHA) * rgb + BLEND_ALPHA * attn_col * acc)

    return _exact_frames(camera_path, frame, vol_mod.grid.densities.device, "attention blend")

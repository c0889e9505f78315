"""Rendered feedback panels of a training run and the camera-ray picture of
a dataset (counterpart of voxe_tpu/viz/static.py: `postprocess_depth_map`,
`visualize_camera_rays`, `visualize_sh_vox_grid_vol_mod_rendered_feedback`
and its attention twin).

PNGs are written with Pillow; the depth colormap is matplotlib's "magma"
resampled to 1024 entries, looked up here from its listed values
(`_magma.py`), and the attention colormap is matplotlib's "jet" (`_jet.py`),
so neither imageio nor matplotlib is needed. The camera rays are drawn in
the fixed orthographic view of the refinement's 3-D scatters
(`viz/refinement.py`), not with matplotlib's 3-D axes.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
from PIL import Image, ImageDraw

from voxe_tpu_torch.utils.camera import CameraIntrinsics, CameraPose, adjust_dynamic_range, to8b
from voxe_tpu_torch.utils.constants import EXTRA_ACCUMULATED_WEIGHTS
from voxe_tpu_torch.viz._jet import JET_256
from voxe_tpu_torch.viz._magma import MAGMA_256


def _colormap(lut: np.ndarray, x) -> np.ndarray:
    """A listed colormap at float values `x` as matplotlib looks it up: index
    floor(x * N) in x's own dtype, x = 1 maps to the last entry, values below
    0 or above 1 to the end entries, NaN to black."""
    n = lut.shape[0]
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over], idx[bad] = 0, n - 1, 0
    out = lut.take(idx, axis=0)
    out[bad] = 0.0
    return out


MAGMA_1024 = _colormap(MAGMA_256, np.linspace(0, 1, 1024))  # magma.resampled(1024)


def postprocess_depth_map(depth_map, acc_map: Optional[np.ndarray] = None) -> np.ndarray:
    """Magma-coloured depth, composited onto white where `acc_map` is low.
    Returns uint8 [H, W, 3]."""
    depth_map = np.asarray(depth_map)
    if depth_map.ndim == 3 and depth_map.shape[-1] == 1:
        depth_map = depth_map[..., 0]
    if acc_map is not None:
        acc_map = np.asarray(acc_map)
        fg_depth = depth_map * np.squeeze(acc_map, axis=-1)
        depth_min, depth_max = depth_map.min(), fg_depth.max()
    else:
        depth_min, depth_max = depth_map.min(), depth_map.max()
    depth_map = adjust_dynamic_range(
        depth_map, (depth_min, depth_max if depth_max > depth_min else depth_min + 1e-6), (0, 1), slack=True
    )
    coloured = _colormap(MAGMA_1024, depth_map)
    if acc_map is not None:
        nr = coloured * acc_map + (1.0 - acc_map) ** 2
        dr = acc_map + (1.0 - acc_map) ** 2
        return to8b(nr / dr)
    return to8b(coloured)


def camera_ray_geometry(poses, intrinsics: CameraIntrinsics, num_rays_per_image: int = 1):
    """(origins [N, 3], directions [N, R, 3]) in float64 of R pixels per
    [N, 3, 4] pose, evenly spaced over the flat pixel index: pixel centres
    at +0.5, the camera looking down -z with +y up (`cast_rays`' rays at
    those pixels)."""
    h, w, focal = intrinsics.height, intrinsics.width, float(intrinsics.focal)
    picks = np.linspace(0, h * w - 1, num_rays_per_image).astype(int)
    px, py = picks % w + 0.5, picks // w + 0.5
    dirs_cam = np.stack([(px - w * 0.5) / focal, -(py - h * 0.5) / focal, -np.ones_like(px)], axis=-1)
    poses = np.asarray(poses, np.float64)
    return poses[:, :, 3], np.einsum("rj,nij->nri", dirs_cam, poses[:, :, :3])


def visualize_camera_rays(dataset, output_dir: Path, num_rays_per_image: int = 1) -> None:
    """`camera_rays.png`: each camera's origin (red) and `num_rays_per_image`
    of its rays, 1.5 direction lengths long (blue)."""
    from voxe_tpu_torch.viz.refinement import _CANVAS, _project

    origins, dirs = camera_ray_geometry(dataset.poses, dataset.camera_intrinsics, num_rays_per_image)
    ends = origins[:, None, :] + 1.5 * dirs
    xyd = _project(np.concatenate([origins, ends.reshape(-1, 3)]))
    img = Image.new("RGB", _CANVAS, (255, 255, 255))
    draw = ImageDraw.Draw(img)
    n, r = len(origins), 3
    for i in range(n):
        for j in range(num_rays_per_image):
            end = xyd[n + i * num_rays_per_image + j]
            draw.line([tuple(xyd[i, :2]), tuple(end[:2])], fill=(31, 119, 180), width=2)
    for x, y, _ in xyd[:n]:
        draw.ellipse([x - r, y - r, x + r, y + r], fill=(214, 39, 40))
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    img.save(output_dir / "camera_rays.png")


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def visualize_sh_vox_grid_vol_mod_rendered_feedback(
    vol_mod,
    vol_mod_name: str,
    render_feedback_pose: CameraPose,
    camera_intrinsics: CameraIntrinsics,
    global_step: int,
    feedback_logs_dir: Path,
    training_time: float = 0.0,
    log_diffuse_rendered_version: bool = True,
    overridden_num_samples_per_ray: Optional[int] = None,
    verbose_rendering: bool = False,
    use_shear_warp: bool = False,
) -> None:
    """Write `<name>_iter_<step>.png` (colour | depth | 1 - acc side by side)
    and, with `log_diffuse_rendered_version`, `<name>_diffuse_iter_<step>.png`.
    `use_shear_warp` renders through the shear-warp screen render."""
    overrides = {}
    if overridden_num_samples_per_ray is not None:
        overrides["num_samples_per_ray"] = overridden_num_samples_per_ray
    if use_shear_warp:
        overrides["use_shear_warp"] = True
    out = vol_mod.render(camera_intrinsics, render_feedback_pose, **overrides)
    colour, depth = _host(out.colour), _host(out.depth)
    acc = _host(out.extra[EXTRA_ACCUMULATED_WEIGHTS])
    depth_img = postprocess_depth_map(depth, acc_map=acc)
    acc_img = to8b(np.repeat(1.0 - acc, 3, axis=-1))
    panel = np.concatenate([to8b(colour), depth_img, acc_img], axis=1)
    feedback_logs_dir = Path(feedback_logs_dir)
    feedback_logs_dir.mkdir(parents=True, exist_ok=True)
    Image.fromarray(panel).save(feedback_logs_dir / f"{vol_mod_name}_iter_{global_step}.png")
    if log_diffuse_rendered_version:
        out_d = vol_mod.render(camera_intrinsics, render_feedback_pose, render_diffuse=True, **overrides)
        Image.fromarray(to8b(_host(out_d.colour))).save(
            feedback_logs_dir / f"{vol_mod_name}_diffuse_iter_{global_step}.png"
        )


def visualize_sh_vox_grid_vol_mod_rendered_feedback_attn(
    vol_mod,
    vol_mod_name: str,
    render_feedback_pose: CameraPose,
    camera_intrinsics: CameraIntrinsics,
    global_step: int,
    feedback_logs_dir: Path,
    use_shear_warp: bool = False,
) -> None:
    """Write `<name>_attn_iter_<step>.png`: colour | jet-coloured attention
    (clipped to [0, 1]) | their 0.55 / 0.45 blend."""
    overrides = {"use_shear_warp": True} if use_shear_warp else {}
    rgb = _host(vol_mod.render(camera_intrinsics, render_feedback_pose, **overrides).colour)
    attn = _host(vol_mod.render(camera_intrinsics, render_feedback_pose, attn=True, **overrides).colour)[..., 0]
    attn_col = _colormap(JET_256, np.clip(attn, 0, 1))
    blend = 0.55 * rgb + 0.45 * attn_col
    panel = np.concatenate([to8b(rgb), to8b(attn_col), to8b(blend)], axis=1)
    feedback_logs_dir = Path(feedback_logs_dir)
    feedback_logs_dir.mkdir(parents=True, exist_ok=True)
    Image.fromarray(panel).save(feedback_logs_dir / f"{vol_mod_name}_attn_iter_{global_step}.png")

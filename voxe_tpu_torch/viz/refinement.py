"""Refinement-stage diagnostics as PNGs (counterpart of
voxe_tpu/viz/refinement.py): the edit / object / difference attention
maps, per-grid mask / predicted attention / masked difference of the
attention render, the edit-vs-object render difference, and three 3-D
scatters of the voxel cloud (by attention-difference sign, in feature
space, by graph-cut cluster).

The maps are coloured with matplotlib's "jet" carried as data (`_jet.py`)
and written with Pillow. The JAX package draws the scatters with
matplotlib's 3-D axes; here the same subsample (same seed) with the same
colourings is drawn as a fixed orthographic projection (matplotlib's
default 3-D view: azimuth -60, elevation 30) on a 704x528 canvas, under the
same file names; its pixels are not matplotlib's.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

from voxe_tpu_torch.viz._jet import JET_256
from voxe_tpu_torch.viz.static import _colormap


def _as_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _normalize(arr: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """matplotlib's Normalize on a float32 array: the arithmetic in float64
    against the float64 limits, each result stored back as float32."""
    if vmin > vmax:
        raise ValueError("minvalue must be less than or equal to maxvalue")
    out = arr.astype(np.float32, copy=True)
    if vmin == vmax:
        return np.zeros_like(out)
    out -= np.float64(vmin)
    out /= np.float64(vmax) - np.float64(vmin)
    return out


def _jet(arr: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """[..., 3] jet colours in [0, 1] of `arr` between vmin and vmax (its
    own min / max when not given)."""
    arr = np.asarray(arr, dtype=np.float32)
    vmin = float(arr.min()) if vmin is None else vmin
    vmax = float(arr.max()) if vmax is None else vmax
    return _colormap(JET_256, _normalize(arr, vmin, vmax))


def _jet_png(arr, path: Path, vmin=None, vmax=None) -> None:
    Image.fromarray((_jet(arr, vmin, vmax) * 255).astype(np.uint8)).save(path)


def visualize_attention_maps(edit_attn_map, object_attn_map, step: int, out_dir: Path) -> None:
    """`edit_attn_map_<step>.png`, `object_attn_map_<step>.png` and
    `diff_attn_map_<step>.png`."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    e, o = _as_np(edit_attn_map), _as_np(object_attn_map)
    _jet_png(e, out_dir / f"edit_attn_map_{step}.png", vmin=0.0)
    _jet_png(o, out_dir / f"object_attn_map_{step}.png", vmin=0.0)
    _jet_png(e - o, out_dir / f"diff_attn_map_{step}.png")


def visualize_attn_render_diagnostics(attn_render, attn_map, token: str, step: int, out_dir: Path) -> None:
    """Mask / predicted attention / masked difference of an attention render
    against its target map (`mask_`, `pred_attn_`, `diff_masked_<token>_<step>.png`)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    target = _as_np(attn_map)
    render = _as_np(attn_render).reshape(target.shape)
    mask = (render > 0.0).astype(np.float32)
    diff_masked = np.abs(render - target) * mask
    _jet_png(mask, out_dir / f"mask_{token}_{step}.png", vmin=0.0)
    _jet_png(render, out_dir / f"pred_attn_{token}_{step}.png", vmin=0.0)
    _jet_png(diff_masked, out_dir / f"diff_masked_{token}_{step}.png", vmin=0.0)


def visualize_render_diff(edit_attn_render, object_attn_render, step: int, out_dir: Path) -> None:
    """`render_diff_<step>.png`: edit render minus object render."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    _jet_png(_as_np(edit_attn_render) - _as_np(object_attn_render), out_dir / f"render_diff_{step}.png")


_CANVAS = (704, 528)  # matplotlib's default 6.4 x 4.8 inch figure at 110 dpi


def _project(points: np.ndarray, azim: float = -60.0, elev: float = 30.0) -> np.ndarray:
    """Orthographic view of [N, 3] points onto the canvas: (x, y, depth)."""
    a, e = np.radians(azim), np.radians(elev)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.cos(a) * np.sin(e), -np.sin(a) * np.sin(e), np.cos(e)])
    toward = np.array([np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e)])
    lo, hi = points.min(0), points.max(0)
    p = (points - (lo + hi) / 2) / max(float((hi - lo).max()), 1e-6)  # the data box into a unit cube
    u, v, d = p @ right, p @ up, p @ toward
    w, h = _CANVAS
    scale = 0.8 * min(w, h)
    return np.stack([w / 2 + u * scale, h / 2 - v * scale, d], axis=-1)


def _scatter_png(path: Path, points: np.ndarray, groups) -> None:
    """`groups`: (mask, marker "o" or "^", [N, 3] colours in [0, 1]); points
    drawn back to front."""
    img = Image.new("RGB", _CANVAS, (255, 255, 255))
    draw = ImageDraw.Draw(img)
    xyd = _project(points)
    items = []
    for mask, marker, colours in groups:
        for i in np.flatnonzero(mask):
            items.append((xyd[i, 2], xyd[i, 0], xyd[i, 1], marker, tuple(int(c * 255) for c in colours[i])))
    r = 4
    for _, x, y, marker, colour in sorted(items, key=lambda t: t[0]):
        if marker == "^":
            draw.polygon([(x, y - r), (x - r, y + r), (x + r, y + r)], fill=colour)
        else:
            draw.ellipse([x - r, y - r, x + r, y + r], fill=colour)
    img.save(path)


def plot_attn_scatter(
    locations: np.ndarray,  # [N, 3] voxel coords
    features: np.ndarray,  # [N, 3] in [0, 1]
    edit_attn: np.ndarray,  # [N]
    object_attn: np.ndarray,  # [N]
    cluster_ids: np.ndarray,  # [N] graph-cut segments (0 = edit side)
    step: int,
    out_dir: Path,
    num_samples: int = 1000,
    seed: int = 0,
) -> None:
    """`scatter3d_locations_<step>.png` (circles: higher object attention,
    triangles: higher edit attention, coloured by feature),
    `scatter3d_features_<step>.png` (the voxels in feature space, jet by
    attention difference) and `scatter3d_ids_<step>.png` (circles: edit
    cluster, triangles: object cluster)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    locations = np.asarray(locations, np.float32)
    features = np.clip(np.asarray(features, np.float32), 0.0, 1.0)
    edit_attn = np.asarray(edit_attn, np.float32).reshape(-1)
    object_attn = np.asarray(object_attn, np.float32).reshape(-1)
    cluster_ids = np.asarray(cluster_ids).reshape(-1)

    rng = np.random.default_rng(seed)
    n = locations.shape[0]
    sel = rng.permutation(n)[: min(num_samples, n)]
    loc, feat = locations[sel], features[sel]
    diff = edit_attn[sel] - object_attn[sel]
    ids = cluster_ids[sel]

    _scatter_png(out_dir / f"scatter3d_locations_{step}.png", loc,
                 [(diff < 0.0, "o", feat), (diff >= 0.0, "^", feat)])
    _scatter_png(out_dir / f"scatter3d_features_{step}.png", feat,
                 [(np.ones(len(sel), bool), "o", _jet(diff))])
    _scatter_png(out_dir / f"scatter3d_ids_{step}.png", loc, [(ids == 0, "o", feat), (ids == 1, "^", feat)])

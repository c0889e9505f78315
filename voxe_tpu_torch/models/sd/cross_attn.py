"""Cross-attention map aggregation and per-token extraction (counterpart of
voxe_tpu/models/sd/cross_attn.py).

The UNet's capture path (unet.py, `attn_store`) collects head-averaged
[B, Q, K] cross-attention maps; this module averages the ones at 16x16
(Q = 256) over the down/mid/up layers, takes the conditional half of the
CFG batch, and per requested token blurs the map (3x3 gaussian, sigma 0.5,
edge padding) and upsamples it bilinearly to the render's size
(half-pixel centres, as `jax.image.resize` does it when enlarging).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from voxe_tpu_torch.utils import tracing

AGGREGATION_RES = 16  # the reference aggregates the 16x16 maps


def aggregate_attention(attn_store, res: int = AGGREGATION_RES, select: int = 1) -> torch.Tensor:
    """Mean of every captured map with res*res queries, for batch item
    `select` (the conditional half): [res, res, num_tokens]. `attn_store`
    holds the UNet's (tag, [B, Q, K] map) pairs."""
    selected = [m[select] for _, m in attn_store if m.shape[1] == res * res]
    if not selected:
        raise ValueError(f"no attention maps at resolution {res}x{res} captured")
    return torch.stack(selected).mean(dim=0).reshape(res, res, -1)


def gaussian_smooth_maps(maps: torch.Tensor, kernel_size: int = 3, sigma: float = 0.5) -> torch.Tensor:
    """Gaussian blur of [B, H, W] maps with replicate padding, in one conv."""
    ax = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    kernel2d = np.outer(g, g)
    kernel = tracing.upload(kernel2d / kernel2d.sum(), "maps.kernel", dtype=maps.dtype, device=maps.device)
    pad = kernel_size // 2
    padded = F.pad(maps[:, None], (pad, pad, pad, pad), mode="replicate")
    return F.conv2d(padded, kernel[None, None])[:, 0]


@tracing.traced("sd.maps")
def aggregate_token_maps(
    attn_store,
    token_indices: Sequence[int],
    orig_im_h: int,
    orig_im_w: int,
    res: int = AGGREGATION_RES,
    smooth: bool = True,
) -> torch.Tensor:
    """Per-token [B, H, W] maps at the render's size for the CLIP token
    positions `token_indices` (a list or an integer tensor)."""
    agg = aggregate_attention(attn_store, res=res)  # [res, res, K]
    idx = tracing.upload(token_indices, "maps.tokens", dtype=torch.long, device=agg.device)
    token_maps = agg.index_select(-1, idx).permute(2, 0, 1)  # [B, res, res]
    if smooth:
        token_maps = gaussian_smooth_maps(token_maps)
    return upsample_maps(token_maps, orig_im_h, orig_im_w)


def upsample_maps(maps: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Enlarge [B, h, w] maps to [B, height, width] bilinearly with
    half-pixel centres and clamped edges: `jax.image.resize(..., "bilinear")`
    when it enlarges (it antialiases only when it shrinks)."""
    return F.interpolate(maps[:, None], size=(height, width), mode="bilinear", align_corners=False)[:, 0]


def normalize_attn_map(attn_map: torch.Tensor) -> torch.Tensor:
    """Min-max normalise a map to [0, 1]."""
    lo, hi = attn_map.min(), attn_map.max()
    return (attn_map - lo) / (hi - lo + 1e-8)

"""Plain losses, the attention token maps and Adam, in float32."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def density_correlation_loss(density: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """1 - the Pearson correlation of two density grids (Vox-E's volumetric
    regulariser), with the eps terms of the reference implementation."""
    eps = 1e-7
    d, r = density - density.mean(), reference - reference.mean()
    denom = torch.sqrt((d**2).mean() * (r**2).mean() + eps * eps)
    return 1.0 - (d * r / (denom + eps)).mean()


def tv_loss(grid: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference along each axis of [X, Y, Z, C], averaged."""
    return sum(torch.diff(grid, dim=a).abs().mean() for a in range(3)) / 3.0


def masked_attention_l1(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 over the pixels where the rendered channel is positive."""
    rendered, target = rendered.reshape(-1), target.reshape(-1)
    mask = (rendered > 0.0).float()
    return ((rendered - target).abs() * mask).sum() / (mask.sum() + 1e-8)


def token_maps(store: List[torch.Tensor], token_positions, size: int, res: int = 16) -> torch.Tensor:
    """[T, size, size] maps of the token positions: the conditional half's
    head-averaged cross-attention probabilities at res x res queries,
    averaged over the layers, blurred (3x3 gaussian, sigma 0.5, edge
    padding) and enlarged bilinearly (half-pixel centres)."""
    maps = [m[1] for m in store if m.shape[1] == res * res]
    agg = torch.stack(maps).mean(dim=0).reshape(res, res, -1)
    sel = agg[..., list(token_positions)].permute(2, 0, 1)
    ax = np.arange(3) - 1.0
    g = np.exp(-0.5 * (ax / 0.5) ** 2)
    k = np.outer(g, g)
    kernel = torch.as_tensor(k / k.sum(), dtype=torch.float32, device=sel.device)
    blurred = F.conv2d(F.pad(sel[:, None], (1, 1, 1, 1), mode="replicate"), kernel[None, None])
    return F.interpolate(blurred, size=(size, size), mode="bilinear", align_corners=False)[:, 0]


def select_targets(maps: torch.Tensor, edit_mask: torch.Tensor, object_mask: torch.Tensor):
    """(edit target, object target): the max over the maps each mask picks;
    a zero object target when its mask picks none."""
    edit = maps[edit_mask > 0].amax(dim=0)
    if not bool((object_mask > 0).any()):
        return edit, torch.zeros_like(edit)
    return edit, maps[object_mask > 0].amax(dim=0)


class Adam:
    """Adam with b1 0.9, b2 0.999 and eps 1e-8 added to the bias-corrected
    root; `lr` is a function of the count of earlier updates."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr = self.lr(self.count)
        self.count += 1
        c1, c2 = 1.0 - self.b1**self.count, 1.0 - self.b2**self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr / c1 * self.m[k] / (torch.sqrt(self.v[k] / c2) + self.eps))


def staircase(init: float, every: int, gamma: float, begin: int = 0):
    """The learning rate after `count` updates: `init`, times `gamma` once
    for every `every` updates past `begin`."""
    return lambda count: init if count <= begin else init * gamma ** ((count - begin) // every)

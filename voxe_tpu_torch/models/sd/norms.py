"""GroupNorm for the SD stack (counterpart of voxe_tpu/models/sd/norms.py).

Same statistics as `ReduceFirstGroupNorm`: per-channel first and second
moments in f32, folded to group moments, variance E[x^2] - E[x]^2 clamped at
0, then one affine pass `y = x * a_c + b_c` with gamma, beta and the mean
shift folded into per-channel a and b. Parameters are `weight`/`bias` of
[C] (flax `scale`/`bias`). Works on [B, C, ...] in any memory format.
"""
from __future__ import annotations

import torch
from torch import nn


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        if num_channels % num_groups != 0:
            raise ValueError(f"channels {num_channels} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.num_groups
        reps = C // G
        spatial = tuple(range(2, x.ndim))
        per_group = float(x[0, 0].numel() * reps)
        xf = x.float()
        s1 = xf.sum(spatial)  # [B, C]
        s2 = (xf * xf).sum(spatial)
        g1 = s1.reshape(B, G, reps).sum(-1) / per_group  # group mean
        g2 = s2.reshape(B, G, reps).sum(-1) / per_group  # E[x^2]
        var = torch.clamp(g2 - g1 * g1, min=0.0)
        rstd = torch.rsqrt(var + self.eps)
        a = rstd.repeat_interleave(reps, dim=-1) * self.weight.float()[None]
        b = self.bias.float()[None] - g1.repeat_interleave(reps, dim=-1) * a
        bshape = (B, C) + (1,) * (x.ndim - 2)
        return (xf * a.reshape(bshape) + b.reshape(bshape)).to(x.dtype)

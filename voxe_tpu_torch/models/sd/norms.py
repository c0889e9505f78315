"""GroupNorm for the SD stack (counterpart of voxe_tpu/models/sd/norms.py).

Same statistics as `ReduceFirstGroupNorm`: per-channel first and second
moments in f32, folded to group moments, variance E[x^2] - E[x]^2 clamped at
0, then one affine pass `y = x * a_c + b_c` with gamma, beta and the mean
shift folded into per-channel a and b. With `silu`, the SiLU that the blocks
apply to the norm's output runs inside the norm: on the card in the same
kernel (`voxe_tpu_torch/ops/group_norm.py`), elsewhere as `F.silu` after the
plain version's cast. Parameters are `weight`/`bias` of [C] (flax
`scale`/`bias`). Works on [B, C, ...] in any memory format on the CPU; on the
card on 4-D channels_last or contiguous tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from voxe_tpu_torch.ops.group_norm import group_norm


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6, silu: bool = False):
        super().__init__()
        if num_channels % num_groups != 0:
            raise ValueError(f"channels {num_channels} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.silu)

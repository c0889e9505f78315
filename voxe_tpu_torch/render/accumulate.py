"""Render output type and the NaN-safe disparity
(counterpart of the parts of voxe_tpu/render/accumulate.py the shear-warp
path uses)."""
from typing import Dict, NamedTuple

import torch

from voxe_tpu_torch.utils.constants import ZERO_PLUS


class RenderOut(NamedTuple):
    colour: torch.Tensor  # [N, C]
    depth: torch.Tensor  # [N, 1]
    extra: Dict[str, torch.Tensor]


def safe_disparity(depth_render: torch.Tensor, acc_render: torch.Tensor) -> torch.Tensor:
    """1 / (depth/acc), clamping the denominator so rays with acc == 0 give
    a finite value instead of 0/0."""
    return 1.0 / torch.clamp(
        depth_render / torch.clamp(acc_render, min=ZERO_PLUS), min=ZERO_PLUS
    )

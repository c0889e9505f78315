"""What an entry's set-up hands to the harness."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch


@dataclass
class Session:
    """`step` runs one unit of the cell's work through the program's own call
    (the window calls it back to back); `readings` are the program's first
    three steps' numbers for the check; `leaves` the trained tensors;
    `units_per_step` what one step counts toward a rate (rays, for recon)."""

    step: Callable[[], object]
    readings: dict
    leaves: Dict[str, torch.Tensor]
    units_per_step: int = 1

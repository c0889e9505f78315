"""Miscellaneous helpers (counterpart of voxe_tpu/utils/misc.py; only what
the edit step needs)."""
from typing import Tuple

import numpy as np

from voxe_tpu_torch.utils.constants import NUM_COORD_DIMENSIONS


def compute_expected_density_scale_for_relu_field_grid(
    grid_world_size: Tuple[float, float, float],
) -> float:
    """Density scale heuristic = (sqrt(27) * 100 / diagonal) / 3
    (reference: thre3d_atom/rendering/volumetric/utils/misc.py:77-87)."""
    diagonal_norm = float(np.sqrt(np.sum([d**2 for d in grid_world_size])))
    percent_density_scale, constant_grid_norm = 100.0, float(np.sqrt(3.0**3))
    return ((constant_grid_norm * percent_density_scale) / diagonal_norm) / (
        NUM_COORD_DIMENSIONS
    )

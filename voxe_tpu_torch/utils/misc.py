"""Miscellaneous helpers (counterpart of voxe_tpu/utils/misc.py)."""
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from voxe_tpu_torch.utils.constants import NUM_COORD_DIMENSIONS


def compute_thre3d_grid_sizes(
    final_required_resolution: Tuple[int, int, int], num_stages: int, scale_factor: float
) -> Sequence[Tuple[int, int, int]]:
    """Stagewise coarse-to-fine grid resolutions, smallest first."""
    x, y, z = final_required_resolution
    grid_sizes = [(x, y, z)]
    for _ in range(num_stages - 1):
        x = int(np.ceil((1 / scale_factor) * x))
        y = int(np.ceil((1 / scale_factor) * y))
        z = int(np.ceil((1 / scale_factor) * z))
        grid_sizes.insert(0, (x, y, z))
    return grid_sizes


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


def log_config_to_disk(config: Dict, output_dir: Path, name: str = "config") -> None:
    """Write the run configuration as `key: repr(value)` lines."""
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / f"{name}.yml", "w") as f:
        for key in sorted(config):
            f.write(f"{key}: {config[key]!r}\n")

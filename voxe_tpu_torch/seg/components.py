"""Largest-connected-component post-processing of an edited grid
(counterpart of voxe_tpu/seg/components.py): binarise the edited density
at 0, label its 26-connected components, and give every voxel outside the
largest one its pre-edit density back."""
from __future__ import annotations

import numpy as np

from voxe_tpu_torch.seg.native import largest_k
from voxe_tpu_torch.utils.logging import log


def scc_post_process(
    densities: np.ndarray,  # [X, Y, Z, 1] edited raw densities
    ref_densities: np.ndarray,  # [X, Y, Z, 1] pre-edit raw densities
    k: int = 10,
    connectivity: int = 26,
) -> np.ndarray:
    """The post-processed density grid."""
    binary = (densities[..., 0] > 0).astype(np.uint8)
    labels, num = largest_k(binary, k=k, connectivity=connectivity)
    log.info(f"SCC post-process: {num} components; keeping the largest")
    out = densities.copy()
    mask = labels != k  # the largest component carries label k
    out[mask] = ref_densities[mask]
    return out

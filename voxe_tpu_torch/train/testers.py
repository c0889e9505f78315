"""Held-out evaluation: per-image PSNR and SSIM over a test dataset with the
exact renderer (counterpart of voxe_tpu/train/testers.py). LPIPS is not
ported yet."""
from __future__ import annotations

import numpy as np
import torch

from voxe_tpu_torch.utils.camera import CameraPose
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.metrics import psnr, ssim


def test_sh_vox_grid_vol_mod_with_posed_images(vol_mod, test_dataset, global_step: int = 0) -> dict:
    """Mean PSNR and SSIM of `vol_mod.render` against every held-out image."""
    intrinsics = test_dataset.camera_intrinsics
    dev = vol_mod.grid.densities.device
    psnrs, ssims = [], []
    log.info(f"computing test metrics on {len(test_dataset)} heldout images")
    for i in range(len(test_dataset)):
        pose_arr = test_dataset.poses[i]
        pose = CameraPose(rotation=pose_arr[:, :3], translation=pose_arr[:, 3:])
        pred = vol_mod.render(intrinsics, pose).colour
        image = torch.from_numpy(test_dataset.images[i]).to(dev)
        psnrs.append(float(psnr(pred, image)))
        ssims.append(float(ssim(pred, image)))
    metrics = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    log.info(f"test metrics (step {global_step}): psnr={metrics['psnr']:.3f} ssim={metrics['ssim']:.4f}")
    return metrics


"""Held-out evaluation: per-image PSNR and SSIM over a test dataset with the
exact renderer, and LPIPS-VGG when its weights load from a local directory
(counterpart of voxe_tpu/train/testers.py)."""
from __future__ import annotations

import os

import numpy as np
import torch

from voxe_tpu_torch.utils.camera import CameraPose
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.metrics import psnr, ssim


def test_sh_vox_grid_vol_mod_with_posed_images(
    vol_mod,
    test_dataset,
    tensorboard_writer=None,
    global_step: int = 0,
    lpips_weights_dir=None,
) -> dict:
    """Mean PSNR and SSIM of `vol_mod.render` against every held-out image,
    and mean LPIPS when `lpips_weights_dir` (else `$VOXE_LPIPS_WEIGHTS_DIR`)
    holds `vgg16.pth` and `lpips_vgg.pth`. With a `tensorboard_writer`, each
    metric goes to the scalar `test_<name>` at `global_step`."""
    intrinsics = test_dataset.camera_intrinsics
    dev = vol_mod.grid.densities.device
    if lpips_weights_dir is None:
        lpips_weights_dir = os.environ.get("VOXE_LPIPS_WEIGHTS_DIR") or None
    lpips_fn = None
    if lpips_weights_dir is not None:
        from voxe_tpu_torch.models.lpips import try_load_lpips

        lpips_fn = try_load_lpips(lpips_weights_dir)
    psnrs, ssims, lpipss = [], [], []
    log.info(f"computing test metrics on {len(test_dataset)} heldout images")
    for i in range(len(test_dataset)):
        pose_arr = test_dataset.poses[i]
        pose = CameraPose(rotation=pose_arr[:, :3], translation=pose_arr[:, 3:])
        pred = vol_mod.render(intrinsics, pose).colour
        image = torch.from_numpy(test_dataset.images[i]).to(dev)
        psnrs.append(float(psnr(pred, image)))
        ssims.append(float(ssim(pred, image)))
        if lpips_fn is not None:
            lpipss.append(lpips_fn(pred, image))
    metrics = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    msg = f"test metrics (step {global_step}): psnr={metrics['psnr']:.3f} ssim={metrics['ssim']:.4f}"
    if lpipss:
        metrics["lpips"] = float(np.mean(lpipss))
        msg += f" lpips={metrics['lpips']:.4f}"
    log.info(msg, extra={"test_metrics": metrics, "global_step": global_step})
    if tensorboard_writer is not None:
        for name, value in metrics.items():
            tensorboard_writer.add_scalar(f"test_{name}", value, global_step=global_step)
    return metrics

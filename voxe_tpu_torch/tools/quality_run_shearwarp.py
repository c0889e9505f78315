"""Production-scale recon quality run on the shear-warp path, with the
PyTorch port (counterpart of tools/quality_run_shearwarp.py: the same
flags, with `--device` in place of `--cpu`).

Generates a synthetic posed scene, trains the 4-stage coarse-to-fine ladder
to a 160^3 grid (bf16 resample table) on the shear-warp path with the
compositing kernel (coarse stages on the host CPU, the final stage on the
card), then reports HELD-OUT PSNR through the exact screen-space renderer:
the quality gate for training on base-plane supervision at production
scale (BENCHMARKS.md "Quality"). Prints the JAX tool's `RESULT:` line and
writes it as `result.json` under `--out`.

    python -m voxe_tpu_torch.tools.quality_run_shearwarp [--image 128 --iters 150] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import check_device
from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.train.recon import train_sh_vox_grid_vol_mod_with_posed_images
from voxe_tpu_torch.train.testers import test_sh_vox_grid_vol_mod_with_posed_images
from voxe_tpu_torch.utils.misc import compute_expected_density_scale_for_relu_field_grid


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    a = p.add_argument
    a("--image", type=int, default=128)
    a("--iters", type=int, default=150, help="iterations per stage")
    a("--grid", type=int, default=160)
    a("--views", type=int, default=16, help="training views (reference scenes have ~100)")
    a("--out", type=str, default="quality_sw")
    a("--base", type=int, default=None, help="shear-warp base lattice res (default: 2x stage image res)")
    a("--steps_per_call", type=int, default=1, help="iterations a call")
    a("--exact", action="store_true",
      help="CONTROL: train on the exact per-sample renderer with the same budget instead of shear-warp")
    a("--device", default="cuda", help="cuda (the coarse stages on the CPU) or cpu (everything on the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    check_device(args.device)
    dev = torch.device(args.device)
    out = Path(args.out)
    scene = out / "scene"
    if not (scene / "train_camera_params.json").exists():
        print("generating synthetic scene ...")
        generate_synthetic_scene(scene, num_train=args.views, num_test=4, image_size=args.image,
                                 focal=float(args.image), grid_res=48, device=dev, use_fused_kernel=True)

    def dataset(split):
        return PosedImagesDataset(scene / "images", scene / f"{split}_camera_params.json", rgba_white_bkgd=True,
                                  device=dev)

    train_ds, test_ds = dataset("train"), dataset("test")
    res, world = args.grid, 3.0
    cfg = VoxelGridConfig(
        voxel_size=VoxelSize(*([world / res] * 3)),
        density_preactivation="identity",
        density_postactivation="softplus",
        gather_dtype="bfloat16",
        expected_density_scale=compute_expected_density_scale_for_relu_field_grid((world,) * 3),
    )
    grid = VoxelGrid(torch.zeros((res, res, res, 1), device=dev), torch.zeros((res, res, res, 3), device=dev), cfg)
    rcfg = SHVoxGridRenderConfig(
        num_samples_per_ray=192,
        camera_bounds=train_ds.camera_bounds,
        white_bkgd=True,
        render_num_samples_per_ray=256,
        parallel_rays_chunk_size=16384,
        use_fused_kernel=True,
    )
    t0 = time.time()
    model = train_sh_vox_grid_vol_mod_with_posed_images(
        VolumetricModel(grid, rcfg), train_ds, out / "run", image_batch_cache_size=8, num_stages=4,
        num_iterations_per_stage=args.iters, save_freq=100_000, test_freq=100_000, feedback_freq=100_000,
        summary_freq=50, fast_debug_mode=True, use_shear_warp=not args.exact, shear_warp_base_res=args.base,
        steps_per_call=args.steps_per_call, coarse_stages_on_cpu=dev.type == "cuda",
    )
    wall = time.time() - t0

    # held-out evaluation through the EXACT screen-space renderer
    metrics = test_sh_vox_grid_vol_mod_with_posed_images(model, test_ds)
    train_metrics = test_sh_vox_grid_vol_mod_with_posed_images(model, train_ds)
    print(
        f"RESULT: held-out PSNR {metrics['psnr']:.2f} dB | "
        f"train-view PSNR {train_metrics['psnr']:.2f} dB | "
        f"grid {res}^3 | {4 * args.iters} total iters | wall {wall / 60:.1f} min"
    )
    result = dict(heldout_psnr=metrics["psnr"], heldout_ssim=metrics["ssim"], train_psnr=train_metrics["psnr"],
                  grid=res, image=args.image, views=args.views, iters_per_stage=args.iters,
                  total_iters=4 * args.iters, wall_s=wall, exact=args.exact, device=str(dev))
    (out / "result.json").write_text(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

"""Demo of the SDS edit loop with the analytic oracle denoiser, on the
PyTorch port (counterpart of tools/demo_oracle_edit.py: the same flags plus
`--device` and `--seed`).

Real SD weights are not in the repository, so this demo substitutes the
exact noise predictor of a delta target distribution
(`voxe_tpu_torch/tools/oracle.py`) and runs the real shear-warp edit train
step: differentiable render -> SDS gradient injection -> density
correlation anchor -> Adam. It writes before/after frames side by side
(`before_after.png`), a 12-frame turntable of the edited grid
(`edited_turntable.mp4`, an MJPEG AVI) and `metrics.json`: the colour
distance of the object's pixels to the target before and after, the
density correlation with the pre-edit grid, and ms per step. The frames are
exact renders through the compositing kernel.

    python -m voxe_tpu_torch.tools.demo_oracle_edit --device cpu        # 32^3, 64^2 base
    python -m voxe_tpu_torch.tools.demo_oracle_edit --res 160 --base 256 --out demo_oracle_160
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import check_device
from voxe_tpu_torch.data.synthetic import make_demo_grid
from voxe_tpu_torch.tools.oracle import (
    GOLDEN,
    MaskedOracleSDS,
    demo_render_config,
    object_colour_distance,
    render_frame,
    run_oracle_sds,
)
from voxe_tpu_torch.utils.camera import CameraIntrinsics
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.viz.video import write_video


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    a = p.add_argument
    a("--res", type=int, default=32)
    a("--base", type=int, default=64)
    a("--iters", type=int, default=300)
    a("--eval_size", type=int, default=128)
    a("--out", type=str, default="demo_oracle")
    a("--seed", type=int, default=0)
    a("--device", default="cuda")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    check_device(args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    grid = make_demo_grid(res=args.res, device=args.device)
    ref_d = grid.densities.detach().cpu().numpy().copy()
    rcfg = demo_render_config()
    intr = CameraIntrinsics(args.eval_size, args.eval_size, float(args.eval_size))
    oracle = MaskedOracleSDS(GOLDEN, device=args.device)

    before, colour, acc = render_frame(grid, rcfg, intr, 40.0)
    dist_before = object_colour_distance(colour, acc, GOLDEN)

    def report(i, metrics):
        if i % 50 == 0:
            log.info(f"iter {i}: total_loss {float(metrics['total_loss']):.4f} "
                     f"dcl {float(metrics['density_correlation_loss']):.5f}")

    timing = run_oracle_sds(grid, oracle, rcfg, (args.base, args.base), args.iters, args.seed, on_step=report)
    after, colour, acc = render_frame(grid, rcfg, intr, 40.0)
    dist_after = object_colour_distance(colour, acc, GOLDEN)

    Image.fromarray(np.concatenate([before, after], axis=1)).save(out_dir / "before_after.png")
    frames = [render_frame(grid, rcfg, intr, float(yaw))[0] for yaw in np.linspace(0, 360, 13)[:-1]]
    write_video(out_dir / "edited_turntable.mp4", frames, fps=6)
    corr = float(np.corrcoef(ref_d.ravel(), grid.densities.detach().cpu().numpy().ravel())[0, 1])
    metrics = dict(colour_distance_before=dist_before, colour_distance_after=dist_after, density_correlation=corr,
                   ms_per_step=timing["ms_per_step"], first_step_ms=timing["first_step_ms"], res=args.res,
                   base=args.base, iters=args.iters, device=str(grid.densities.device))
    (out_dir / "metrics.json").write_text(json.dumps(metrics, indent=2))
    log.info(f"wrote {out_dir}/before_after.png and edited_turntable.mp4")
    log.info(f"colour distance to the target: {dist_before:.3f} -> {dist_after:.3f}; "
             f"density correlation with pre-edit grid: {corr:.3f}; {timing['ms_per_step']:.2f} ms a step")
    return metrics


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

"""Demo of the complete localized edit pipeline with analytic oracles, on
the PyTorch port (counterpart of tools/demo_oracle_local_edit.py: the same
flags, stages and `metrics.json` keys, plus `--device`).

The reference's localized-edit recipe (edit_pretrained_relu_field.py:321-373
+ attn_grid_trainer.py:63-627) is: (A) a global SDS edit that may spill
outside the intended region, then (B) attention-grid refinement: learn
volumetric edit/object attention grids against SD cross-attention maps,
graph-cut them into an edit region, and merge: every non-edit voxel reverts
to the pre-edit grid. This demo runs that pipeline with the port's own
pieces (the shear-warp SDS step, `train/refine.py::make_dual_attn_update`,
the C++ graph cut of `seg/graphcut.py::get_edit_region` and
`merge_edit_region`), with the two SD-dependent signals replaced by oracles:

  * stage A: the analytic delta-target denoiser (`tools/oracle.py`)
    recolours the WHOLE object golden, spilling the edit over body + hat;
  * stage B: per-pose edit/object target maps rendered from the
    ground-truth hat/body masks through the same two-channel attention
    shear-warp render the refinement loss uses.

It reports, at any scale up to 160^3: the graph cut's IoU with the hat
region (over dense voxels), whether the merge restored every non-edit body
voxel exactly, the mean |feature delta| the hat kept, the fraction of body
voxels labelled edit; and ms per SDS step, ms per refinement step and the
cut's (graph cut + merge) seconds. Writes before/global-edit/refined frames
side by side, four views of the refined grid and `metrics.json`. The
frames are exact renders through the compositing kernel.

    python -m voxe_tpu_torch.tools.demo_oracle_local_edit --device cpu     # 32^3, 64^2 base
    python -m voxe_tpu_torch.tools.demo_oracle_local_edit --res 160 --base 256 \\
        --sds_iters 300 --refine_iters 300 --out demo_oracle_local_160
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import check_device
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.render.shearwarp import orient_base_image, render_shear_warp
from voxe_tpu_torch.seg.graphcut import get_edit_region, merge_edit_region
from voxe_tpu_torch.tools.oracle import (
    GOLDEN,
    MaskedOracleSDS,
    demo_pose,
    demo_render_config,
    make_hat_scene,
    pose_tensors,
    render_frame,
    run_oracle_sds,
    sync,
)
from voxe_tpu_torch.train.refine import make_attn_adam, make_dual_attn_update
from voxe_tpu_torch.utils.camera import CameraIntrinsics, CameraPose
from voxe_tpu_torch.utils.logging import log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    a = p.add_argument
    a("--res", type=int, default=32)
    a("--base", type=int, default=64)
    a("--sds_iters", type=int, default=250)
    a("--refine_iters", type=int, default=250)
    a("--eval_size", type=int, default=128)
    a("--seed", type=int, default=0)
    a("--out", type=str, default="demo_oracle_local")
    a("--device", default="cuda")
    return p


def refine_with_oracle_maps(grid, hat_mask, body_mask, rcfg, base_hw, iters: int, rng: np.random.Generator):
    """Stage B: the edit and object attention grids (from -20) trained by
    `make_dual_attn_update` (Adam 0.035, TV 0.001) against the hat and body
    masks rendered as one two-channel attention frame of `grid` a pose
    drawn from `rng`. Returns (edit_attn, obj_attn, ms a step after the first)."""
    dev = grid.densities.device
    base = grid.replace(densities=grid.densities.detach(), features=grid.features.detach())
    masks = np.stack([hat_mask, body_mask], axis=-1)
    gt_attn2 = torch.where(torch.from_numpy(masks).to(dev), 6.0, -20.0)

    @torch.no_grad()
    def oracle_maps(rotation, translation):
        out, _ = render_shear_warp(base.replace(attn=gt_attn2), CameraPose(rotation, translation), rcfg,
                                   base_hw=base_hw, attn_mode=True, background_value=0.0)
        maps = orient_base_image(out.colour.reshape(*base_hw, 2), rotation)
        return maps[..., 0], maps[..., 1]

    edit_attn = torch.full_like(base.densities, -20.0)
    obj_attn = edit_attn.clone()
    update = make_dual_attn_update(rcfg, make_attn_adam(edit_attn, 0.035), make_attn_adam(obj_attn, 0.035), base,
                                   base_hw, attn_tv_weight=0.001)
    t0 = t1 = time.perf_counter()
    for i in range(iters):
        rot, trans = pose_tensors(demo_pose(rng), dev)
        metrics = update(edit_attn, obj_attn, rot, trans, *oracle_maps(rot, trans))
        if i == 0:
            sync(dev)
            t1 = time.perf_counter()
        if (i + 1) % 100 == 0:
            log.info(f"[refine] iter {i + 1}: edit {float(metrics['attn_loss_edit']):.4f} "
                     f"obj {float(metrics['attn_loss_object']):.4f}")
    sync(dev)
    return edit_attn.detach(), obj_attn.detach(), (time.perf_counter() - t1) * 1e3 / max(iters - 1, 1)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    check_device(args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    grid, hat_mask, body_mask = make_hat_scene(args.res, device=args.device)
    ref_grid = grid.replace(densities=grid.densities.clone(), features=grid.features.clone())
    rcfg = demo_render_config()
    intr = CameraIntrinsics(args.eval_size, args.eval_size, float(args.eval_size))
    base_hw = (args.base, args.base)
    before = render_frame(grid, rcfg, intr, 40.0)[0]

    # ---------------- stage A: global oracle SDS edit (golden recolour,
    # deliberately unmasked within the object so it spills body + hat)
    def report(i, metrics):
        if i % 100 == 0:
            log.info(f"[sds] iter {i}: loss {float(metrics['total_loss']):.4f}")

    rng = np.random.default_rng(args.seed)  # both stages' poses, as in the JAX demo
    sds = run_oracle_sds(grid, MaskedOracleSDS(GOLDEN, device=args.device), rcfg, base_hw, args.sds_iters,
                         args.seed, on_step=report, rng=rng)
    grid = grid.replace(densities=grid.densities.detach(), features=grid.features.detach())
    edited = render_frame(grid, rcfg, intr, 40.0)[0]

    # ---------------- stage B: oracle attention refinement
    edit_attn, obj_attn, refine_ms = refine_with_oracle_maps(grid, hat_mask, body_mask, rcfg, base_hw,
                                                             args.refine_iters, rng)

    # ---------------- graph cut + merge (the production path)
    t0 = time.perf_counter()
    vm_out = VolumetricModel(grid.replace(attn=torch.full_like(edit_attn, -20.0)), rcfg)
    get_edit_region(
        vol_mod_edit=VolumetricModel(grid.replace(attn=edit_attn), rcfg),
        vol_mod_object=VolumetricModel(grid.replace(attn=obj_attn), rcfg), vol_mod_output=vm_out,
        K=5.0, num_obj_voxels_thresh=max(50, args.res**3 // 800), min_num_edit_voxels=30, top_k_edit_thresh=30,
        top_k_obj_thresh=20,
    )
    seg_edit = vm_out.grid.attn[..., 0].cpu().numpy() == 0.0
    merge_edit_region(vm_out, VolumetricModel(ref_grid, rcfg))
    refined = vm_out.grid
    sync(refined.densities.device)
    cut_s = time.perf_counter() - t0
    after = render_frame(refined, rcfg, intr, 40.0)[0]

    # ---------------- metrics
    # IoU over DENSE voxels: the graph includes a dilated one-voxel margin of
    # EMPTY voxels, and the diagonal-margin ones have no arcs at all: free
    # nodes, which the min-cut labels edit (the reference behaves the same,
    # refinement_functions.py:293). They never render; the segmentation's
    # quality is measured over voxels that exist.
    ref_d, ref_f = ref_grid.densities.cpu().numpy(), ref_grid.features.cpu().numpy()
    new_d, new_f = refined.densities.cpu().numpy(), refined.features.cpu().numpy()
    keep_mask = ~seg_edit
    seg_edit_dense = seg_edit & (ref_d[..., 0] > 0.0)
    inter = float(np.sum(seg_edit_dense & hat_mask))
    union = float(np.sum(seg_edit_dense | hat_mask))
    iou = inter / max(union, 1.0)
    body_keep = body_mask & keep_mask
    body_restored = np.array_equal(new_f[body_keep], ref_f[body_keep]) and np.array_equal(new_d[body_keep],
                                                                                          ref_d[body_keep])
    hat_edit = hat_mask & seg_edit
    hat_delta = float(np.mean(np.abs(new_f[hat_edit] - ref_f[hat_edit]))) if np.any(hat_edit) else 0.0
    body_off = float(np.sum(body_mask & seg_edit)) / max(float(np.sum(body_mask)), 1)

    log.info(f"segmentation IoU vs GT hat region: {iou:.3f}")
    log.info(f"non-edit voxels restored exactly: {body_restored}")
    log.info(f"mean |feature delta| kept in hat: {hat_delta:.3f}")
    log.info(f"fraction of body voxels mislabeled edit: {body_off:.4f}")
    log.info(f"{sds['ms_per_step']:.2f} ms an SDS step, {refine_ms:.2f} ms a refinement step, cut {cut_s:.2f} s")

    Image.fromarray(np.concatenate([before, edited, after], axis=1)).save(out_dir / "before_globaledit_refined.png")
    for yaw in (0.0, 90.0, 180.0, 270.0):
        Image.fromarray(render_frame(refined, rcfg, intr, yaw)[0]).save(out_dir / f"refined_yaw{int(yaw):03d}.png")
    metrics = dict(
        iou=iou, body_restored=bool(body_restored), hat_feature_delta=hat_delta, body_mislabel_frac=body_off,
        res=args.res, sds_iters=args.sds_iters, refine_iters=args.refine_iters,
        sds_ms_per_step=sds["ms_per_step"], refine_ms_per_step=refine_ms, graph_cut_s=cut_s,
        device=str(refined.densities.device),
    )
    (out_dir / "metrics.json").write_text(json.dumps(metrics, indent=2))
    log.info(f"wrote {out_dir}/before_globaledit_refined.png")
    return metrics


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()

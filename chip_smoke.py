"""Chip smoke test of the PyTorch port (voxe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero; there is no CPU path):
  1. environment: torch / CUDA / nvcc versions, card name and power limit;
  2. build every hand-written kernel from the checkout's sources (one nvcc
     per source, started together);
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes plus ragged and hard shapes; kernel, plain and library
     (timed only, never used by the port) times against the kernel's bound;
     the flash backward (flash-bwd-kernel) at the forward's check shapes and
     the timed shapes: its main pass against the plain f32 backward, its
     preprocess and postprocess launches against their plain versions, a
     second call run to run (dk, dv bitwise), the forward with and without
     its LSE output, SDPA's backward as the library time, the three
     launches' device split (torch.profiler), the TMA-encode host cost, and
     ptxas' registers and spills of every kernel from the build;
  4. small-input checks: the tiny edit step's and a 16^3 shear-warp recon
     step's grid gradients on the card against the same step on the CPU;
  5. the edit main path at full width: the SDS edit step (SD 2.0 at its
     published widths with seeded random weights, 160^3 grid, 384^2 base)
     through `make_sds_train_multi_step`: launch counts, median ms/step with
     its spread, peak memory, a per-layer breakdown and the idle share;
  6. the recon main path at full width: a 400^2 synthetic scene rendered by
     the exact renderer (the compositing kernel's route 2), targets warped to
     the 768^2 base lattice, shear-warp recon steps at 160^3 with the fused
     compositing kernel and Adam (2 launches per step), a breakdown and the
     idle share, then the held-out images through the tester (5 launches per
     400^2 image);
  6a. recon-kstep: that configuration at K = 10 steps a call against K = 1,
     two rounds of 20 steps, each call ending in a loss read;
  7. recon-cli: the recon stage ladder end to end through its CLI module at
     its default flags (4 stages of 3 iterations): camera_rays.png, feedback
     renders at the JAX cadence (2 a stage, 1 compositing launch a render),
     the held-out test at each stage's end (5 launches a 400^2 image; PSNR,
     SSIM and LPIPS-VGG on the card, on seeded random weights), the
     seconds both add to a stage, ending in a model_final.pth that loads
     back;
  7r. recon-cli-resume: the recon CLI with --steps_per_call 10 (4 stages of
     12 iterations), then --resume from its training_state_latest.pth: the
     ladder fast-forwards to stage 4 and continues;
  7s. recon-streaming: one exact-route stage of the 400^2 scene through the
     trainer, RAM-backed, memmap-backed (pixels gathered on the host) and
     RAM-backed again: ms/step of each;
  7a. render-cli-exact: the render CLI on that model_final.pth at its full
     width (800^2, 512 samples, the exact renderer in chunks of 32,768 rays:
     20 compositing launches a frame), 8 frames of the turntable: ms per
     frame, launches per frame, peak memory, the video read back, one
     frame's device profile;
  7b. render-cli-shear-warp: the same through the shear-warp screen render
     (1600^2 base, 1 launch a frame), 36 frames;
  7f. feature-grid: the feature-voxel model (160^3 x 12 features, the
     64 x 4 rgbnet) on the 400^2 scene: ms per image at 512 samples in
     32,768-ray chunks, ms per training step at the recon CLI's ray batch
     (L1, Adam on the grid and the heads), peak memory;
  8. sd-weights: SD 2.0 at its published widths with seeded random weights,
     written as an HF snapshot (safetensors: UNet and VAE in bf16, CLIP in
     f32, a byte-level BPE vocab) and loaded back through
     `StableDiffusion(weights_dir=)`: CLIP, VAE and UNet outputs bitwise equal
     to the source's, the BPE tokenizer in use;
  8s. sd-sample: the validate-weights CLI module on that snapshot at its
     defaults (the SDS smoke, then 50 DDIM steps at CFG 7.5 and 512^2, the
     VAE decode, the PNG): 5 flash launches a CFG UNet pass (255 in all),
     ms per DDIM step, decode ms, the CLI's seconds, peak memory;
 8p. p2p-hook: one SD 2.0 CFG UNet pass at 512^2 plain (flash and SDPA) and
     with an identity probs-edit hook (every attention on the f32 probs
     path, no flash launch): outputs within the flash tolerance, one hook
     call an attention, ms and peak memory of both; then one
     prompt-to-prompt AttentionRefine pass through the hook on the card;
 8g. unet-grad: the SD 2.0 UNet's gradient (latents and one 64^2 to_q
     weight) through the flash kernels, 5 forward and 5 backward launches,
     against the same pass with SDPA in the flash kernel's place; ms and
     peak memory;
 9. edit-cli: the edit CLI module end to end on the recon CLI's
     model_final.pth (160^3, fused compositing) and the 400^2 scene, with
     the snapshot's weights: 6 SDS steps on the 384^2 base, feedback renders
     and checkpoints; 5 flash launches a step, compositing launches on every
     step and feedback render, the training time per step, peak memory;
 10. edit-data-pose: the same CLI in dataset-pose mode, 2 steps;
 11. sd14-weights: SD 1.4 at its published widths (the refinement's model:
     head_dim 40 at 64^2, so the library SDPA there) with seeded random
     weights, written as an HF snapshot and loaded back bitwise; the 64^2
     self-attention's time and transient memory, SDPA against the plain
     version; then
     refine-breakdown: one refinement iteration at full width (160^3, 384^2
     base) layer by layer;
 12. refine-cli: the refine CLI module on the edit-cli phase's
     model_final.pth and the recon CLI's, with the 1.4 snapshot: 6
     shear-warp iterations (2 compositing launches each), feedback and
     snapshots every 3 (5 launches a feedback point), the graph cut and merge
     at 160^3; then the segment CLI on its attention grids;
 12k. refine-kstep: the refine CLI with --steps_per_call 10 over 20
     iterations, graph cut and merge, then the same at --steps_per_call 1;
 13. edit-refine: the edit CLI with --do_refinement and --post_process_scc,
     2 SDS steps and 2 refinement iterations;
 14. render-attn-cli: the attention render CLI on the refine CLI's edit
     attention grid at 800^2: the blend on the shear-warp route (2 launches
     a frame) and the exact route (20: the attention render takes the plain
     compositor), then --use_sd on the SD 1.4 snapshot, 2 frames;
 14g. grid-refine: the legacy grid_refine loop on the CLI phases' 160^3
     grids with SD 1.4 (4 iterations with the attention re-learn, graph cuts
     at 1 and 4): ms per iteration, graph-cut seconds, launches, files;
 14p. parallel-nccl: the data-parallel paths through NCCL at world size 1
     (the group from torchrun's variables through maybe_init_distributed,
     the mesh passed to the builders, so the row split, the gather and the
     gradient all-reduce run): the recon K-step (K = 10, 160^3, 768^2 base,
     the fused compositing kernel) and the SDS edit K-step (K = 3, SD 2.0
     widths, 384^2 base) each sharded against unsharded from the same state,
     in turns: ms per step of both, each NCCL kernel's device ms (torch.profiler),
     the grid gap (recon bitwise expected; the edit at its card tolerance),
     flash and compositing launches; then the recon CLI with --multihost
     True --num_devices 1 (one stage of 3 iterations), its files and its
     model_final.pth read back;
 14b. bf16-mesh-route: the bf16 table's mesh route (the f32 table cast in
     each rank's row resample, an f32 gradient share), which world size 1
     never takes: the row resample at the recon render's shapes against the
     CPU, then the 160^3 / 768^2 recon render's forward and backward through
     two ranks' shares in turn on the card against the one-cast route: ms,
     memory, each gradient's distance from the f32-table gradient;
 14e. eval-cli: the evaluation CLI on a result tree (one scene: inputs,
     recon and two prompt folders of 4 exact 400^2 frames each, through the
     compositing kernel) with a random-weight full-width Inception3 and, where
     transformers imports, a tiny random CLIP: on the card (TF32 off in the
     embedders) and, in a process beside it, with --device cpu on a copy of
     the tree: the CSV layout equal, PSNR equal as text, FID within
     EVAL_FID_REL_TOL; the embedder's images a second;
 14i. import-reference: the reference-checkpoint importer on a
     reference-style pickle of a 160^3 grid (stub thre3d_atom classes, an
     attn channel, camera bounds and intrinsics), read back onto the card
     bitwise, one 400^2 exact frame through the compositing kernel;
 14o. oracle-edit: the oracle SDS edit demo at 160^3 / 256^2 base, 300
     iterations (colour distance to the target at least halved, density
     correlation > 0.9), ms a step, the device's busy share (torch.profiler);
 14l. oracle-local: the local oracle demo at 160^3 / 256^2, 300 + 300
     iterations, the graph cut and merge (body restored, IoU > 0.5, body
     mislabel < 0.2), ms a step of each stage, the cut's seconds;
 14q. quality-recon: the quality tool's 4-stage ladder to 160^3 (128^2
     images, 16 views, coarse stages on the CPU, the last on the card with
     the compositing kernel; 75 iterations a stage, cut from 150), the
     held-out views through the exact renderer above 25 dB;
 15. shape-sweep: the compositing kernel against its plain version at every
     [N, S] it launched in this run that phase 3 did not check;
 16. the `kernels` JSON line, the card line, and the final JSON line.
Every phase's seconds are printed ([phase-seconds]); every phase but the
flash kernels' checks fails if the plain attention ran on the card in it,
and every phase but the backward's check and unet-grad fails if the flash
backward launched in it (no other path differentiates through the UNet).
Imports nothing from JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from voxe_tpu_torch.grid import feature_voxels as fvg
from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize
from voxe_tpu_torch.models.sd.sds import DIRECTION_PROMPTS, StableDiffusion
from voxe_tpu_torch.cli import calculate_metrics as calc_metrics_cli
from voxe_tpu_torch.cli import edit_pretrained_relu_field as edit_cli
from voxe_tpu_torch.cli import import_reference_checkpoint as import_cli
from voxe_tpu_torch.cli import refine_edited_relu_field as refine_cli
from voxe_tpu_torch.cli import render_sh_based_voxel_grid as render_cli
from voxe_tpu_torch.cli import render_sh_based_voxel_grid_attn as render_attn_cli
from voxe_tpu_torch.cli import segment_attn_relu_field as segment_cli
from voxe_tpu_torch.cli import train_sh_based_voxel_grid_with_posed_images as recon_cli
from voxe_tpu_torch.cli import validate_sd_weights as validate_cli
from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene, make_demo_grid
from voxe_tpu_torch.models.lpips import build_vgg16_features
from voxe_tpu_torch.models.sd import cross_attn
from voxe_tpu_torch.models.sd.controllers import AttentionRefine
from voxe_tpu_torch.models.sd import weights as sd_weights
from voxe_tpu_torch.models.sd.tokenizer import CLIPTokenizer, _bytes_to_unicode
from voxe_tpu_torch.models.sd import unet as sd_unet
from voxe_tpu_torch.models.sd.unet import Transformer2D, flash_self_attention_enabled
from voxe_tpu_torch.models.volumetric import VolumetricModel, load_volumetric_model
from voxe_tpu_torch.ops import composite as comp
from voxe_tpu_torch.ops import cuda_build
from voxe_tpu_torch.ops import flash_attention as fa
from voxe_tpu_torch.render.accumulate import _pad_samples
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig, render_feature_voxel_grid
from voxe_tpu_torch.render.rays import Rays, cast_rays, flatten_rays
from voxe_tpu_torch.render.shearwarp import lane_aligned_res, orient_base_image, render_shear_warp
from voxe_tpu_torch.train import recon as train_recon
from voxe_tpu_torch.train import refine as train_refine
from voxe_tpu_torch.train import grid_refine
from voxe_tpu_torch.train import sds as train_sds
from voxe_tpu_torch.train.checkpointing import read_training_state
from voxe_tpu_torch.train.losses import density_correlation_loss
from voxe_tpu_torch.tools import demo_oracle_edit as demo_edit_tool
from voxe_tpu_torch.tools import demo_oracle_local_edit as demo_local_tool
from voxe_tpu_torch.tools import quality_run_shearwarp as quality_tool
from voxe_tpu_torch.tools.oracle import render_frame
from voxe_tpu_torch.train.testers import test_sh_vox_grid_vol_mod_with_posed_images
from voxe_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, CameraPose, pose_spherical
from voxe_tpu_torch.utils.constants import EXTRA_ACCUMULATED_WEIGHTS
from voxe_tpu_torch.utils.misc import compute_expected_density_scale_for_relu_field_grid
from voxe_tpu_torch.viz.animations import render_camera_path_for_volumetric_model
from voxe_tpu_torch.viz.video import read_mjpeg_avi

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (data sheet, SXM, 700 W)
H100_BYTES_PER_S = 3.35e12
# The kernel is held at max|out - ref| / max|ref| < FLASH_REL_TOL. With randn
# q/k/v an output element has std sqrt(e/L) (~0.03 at L = 2500-4096), so an
# absolute limit would have to follow the shape. Both sides round the output
# to bf16 (8 significant bits): one ulp at max|ref| is 2^-8 to 2^-7 of it;
# the kernel's bf16 P in the PV product adds errors that average out over L.
# 2e-2 is ~2.5-5 ulps at max|ref|; a wrong rescale or sum is O(1) relative.
FLASH_REL_TOL = 2e-2
MAIN_SHAPE = (2, 4096, 5, 64)  # SD 2.x 64x64 level, CFG batch 2
LEVEL32_SHAPE = (2, 1024, 10, 64)  # the 32x32 level, below the gate (timed only)
D128_SHAPE = (2, 4096, 5, 128)  # d = 128 at the main length (timed only; no SD 2.x level has it)
# (q shape, key length or None for Lq, q scale): the main shape; a ragged
# d=128 shape; peaked scores (std 4) so the running max moves between key
# tiles and the rescale matters; B = 2 with a ragged length, which catches a
# tile that reads across batches; Lq != Lk; d = 128 at the main length
CHECKS = (
    (MAIN_SHAPE, None, 1.0), ((1, 2500, 2, 128), None, 1.0), ((1, 1000, 3, 64), None, 4.0),
    ((2, 1000, 3, 64), None, 1.0), (MAIN_SHAPE, 1000, 1.0), (D128_SHAPE, None, 1.0),
)
STEPS_PER_CALL, TIMED_CALLS = 3, 8
GRID_RES, BASE, SD_VERSION = 160, lane_aligned_res(400), "2.0"
# The compositing kernel is held at max|w - w_ref| and max|acc - acc_ref| <=
# COMPOSITE_TOL. Both lie in [0, 1]; kernel and plain version take the same
# f32 products in another order (a warp scan plus a carried chunk product
# against a sequential cumprod), whose rounding is bounded by S * 2^-24
# (6.1e-5 at S = 1024) and is ~1e-7 in practice.
COMPOSITE_TOL = 1e-5
# recon main path: the CLI's final stage on a 400^2 scene (dog2's size)
SCENE, RECON_BASE = 400, lane_aligned_res(2 * 400)  # 768^2 base lattice, N = 589,824 rays
RECON_TIMED_STEPS = 8
RECON_RCFG = SHVoxGridRenderConfig(
    num_samples_per_ray=256, camera_bounds=CameraBounds(1.8, 6.6), white_bkgd=True, use_fused_kernel=True,
)  # held-out renders: render_num_samples_per_ray 1024 in chunks of 32,768 rays (the defaults)


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def flash_bound_ms(shape) -> tuple:
    """(bound ms, what bounds it): 4*B*h*L*L*d flops at the bf16 peak against
    q, k, v read and o written once at the memory rate."""
    B, L, Hh, D = shape
    t_ops = 4.0 * B * Hh * L * L * D / H100_BF16_FLOPS * 1e3
    t_bytes = 4.0 * B * L * Hh * D * 2 / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_flash_kernel(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    errs = []
    for shape, lk, q_scale in CHECKS:
        kv_shape = shape if lk is None else (shape[0], lk, *shape[2:])
        q = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) * q_scale
        k, v = (torch.randn(kv_shape, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v).float()
        err = float((out.float() - ref).abs().max())
        rel = err / float(ref.abs().max())
        log("kernel-check", kernel="flash_attn_fwd", shape=list(shape), lk=kv_shape[1], q_scale=q_scale,
            max_abs_err=err, max_abs_ref=float(ref.abs().max()), rel_err=rel, rel_tol=FLASH_REL_TOL)
        if not rel < FLASH_REL_TOL:
            raise AssertionError(f"flash_attn_fwd disagrees with its plain version: {rel}")
        errs.append(err)
    times = {}
    for shape in (MAIN_SHAPE, LEVEL32_SHAPE, D128_SHAPE):
        B, L, Hh, D = shape
        q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound, bound_by = flash_bound_ms(shape)
        times[shape] = (ms, plain_ms, library_ms, bound, bound_by)
        log("kernel-time", kernel="flash_attn_fwd", shape=list(shape), ms=ms, plain_ms=plain_ms,
            sdpa_ms=library_ms, bound_ms=bound, share_of_bound=bound / ms,
            tflops=4.0 * B * Hh * L * L * D / ms / 1e9, tiles=-(-L // 128) * Hh * B,
            waves=-(-L // 128) * Hh * B / torch.cuda.get_device_properties(0).multi_processor_count)
    q = torch.randn(MAIN_SHAPE, device=dev, dtype=torch.bfloat16)
    log("kernel-host", kernel="flash_attn_fwd", what="TMA descriptor encoding per call (4 maps)",
        us=fa.encode_us(q, q, q, torch.empty_like(q)))
    ms, plain_ms, library_ms, bound, bound_by = times[MAIN_SHAPE]
    return dict(
        name="flash_attn_fwd", route="cuda", source="voxe_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="voxe_tpu/models/sd/unet.py:163", launches=0, max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
    )


# The backward is held at max|d - d_ref| / max|d_ref| < FLASH_BWD_REL_TOL for
# each of dq, dk and dv, against the plain f32 backward (its own f32 forward
# output and LSE) from the same bf16 inputs. The kernels round P and dS to
# bf16 as tensor-core operands (8 significant bits) and write bf16; the sums
# over L keys or queries average those roundings out; a wrong term (a
# missing scale, Di or transpose) is O(1) relative. The kernel's LSE is held
# at FLASH_LSE_TOL absolute (natural-log units; f32 sums in another order and
# ex2.approx: ~1e-6). Of the backward's three launches, the preprocess is held
# at FLASH_DI_REL_TOL of max|Di| (f32 sums of d products in another order:
# ~d * 2^-24) with its padded LSE exactly the plain version's, and the
# postprocess bitwise. A second call on the same inputs gives dk and dv
# bitwise (each block owns its keys); dq's key-block partials are added into
# the f32 workspace in the order the blocks finish, so the workspace is held
# at FLASH_DQ_RUN_TOL of its max (~Lk / 128 f32 adds reordered: ~1e-6; a lost
# or doubled partial is ~1 / (Lk / 128)) and the bf16 dq within one bf16 ulp
# of each element plus FLASH_DQ_RUN_TOL of max|dq|: an f32 sum near a
# rounding boundary flips the last bit (2^-9 to 2^-8 of max|dq| at the
# largest elements), and an element near 0 is the workspace's own run-to-run
# noise, which may change its sign.
FLASH_BWD_REL_TOL = 2e-2
FLASH_LSE_TOL = 1e-3
FLASH_DI_REL_TOL = 1e-5
FLASH_DQ_RUN_TOL = 1e-4
BWD_CHECKS = CHECKS + ((LEVEL32_SHAPE, None, 1.0),)
BWD_LAUNCH_NAMES = {"flash_bwd_pre_kernel": "pre", "flash_bwd_kernel": "main", "flash_bwd_post_kernel": "post"}


def flash_bwd_bound_ms(shape, lk=None) -> tuple:
    """(bound ms, what bounds it): five products of 2*B*h*Lq*Lk*d flops (S,
    dP, dV, dK, dQ) at the bf16 peak against q, k, v, o, dO read and dq, dk,
    dv written once (bf16) plus lse and Di (f32) at the memory rate."""
    B, L, Hh, D = shape
    lk = L if lk is None else lk
    t_ops = 5 * 2.0 * B * Hh * L * lk * D / H100_BF16_FLOPS * 1e3
    t_bytes = (2 * (5 * B * L * Hh * D + 3 * B * lk * Hh * D) + 2 * 4 * B * Hh * L) / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def within_bf16_ulp(a, b, floor: float) -> bool:
    """|a - b| <= one bf16 ulp of max(|a|, |b|) + floor, element by element."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()))) - 7)
    return bool(((a - b).abs() <= ulp + floor).all())


def bwd_launch_split_ms(fn, calls: int = 5, passes: int = 3) -> dict:
    """Device ms per call of each of the backward's three launches, from a
    torch.profiler pass over `calls` calls (another pass, up to `passes`,
    when a profile lacks one of the three, as one has in a run)."""
    for _ in range(passes):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            for kernel, label in BWD_LAUNCH_NAMES.items():
                if f"::{kernel}<" in e.key:
                    split[label] = e.device_time_total / e.count / 1e3
        if set(split) == set(BWD_LAUNCH_NAMES.values()):
            return split
    raise AssertionError(f"flash_attn_bwd: {passes} profiles lack a launch: {split}")


def phase_flash_bwd_kernel(dev) -> dict:
    """The backward's kernels against the plain versions at the forward's
    check shapes and the timed shapes (the main pass against the plain
    backward, the preprocess and postprocess against theirs), a second call
    run to run; the forward with and without its LSE output; kernel, plain
    and SDPA-backward times against the bound, the three launches' split and
    the TMA-encode host cost."""
    g = torch.Generator(device=dev).manual_seed(2)
    errs = []
    for shape, lk, q_scale in BWD_CHECKS:
        kv_shape = shape if lk is None else (shape[0], lk, *shape[2:])
        q = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) * q_scale
        k, v = (torch.randn(kv_shape, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
        do = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
        out, lse = fa.flash_attention_with_lse(q, k, v)
        same_out = bool(torch.equal(out, fa.flash_attention(q, k, v)))
        scale = 1.0 / shape[-1] ** 0.5
        *grads, di, lse2, dq_accum = fa.backward_kernels(q, k, v, out, lse, do, scale)
        *again, _, _, accum_again = fa.backward_kernels(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        qf, kf, vf = q.float(), k.float(), v.float()
        lse_ref = fa.flash_attention_lse_reference(qf, kf)
        refs = fa.flash_attention_backward_reference(qf, kf, vf, fa.flash_attention_reference(qf, kf, vf), lse_ref, do)
        lse_err = float((lse - lse_ref).abs().max())
        rel = {n: float((a.float() - r).abs().max() / r.abs().max()) for n, a, r in zip(("dq", "dk", "dv"), grads, refs)}
        di_ref, lse2_ref = fa.flash_attention_bwd_preprocess_reference(out, do, lse, fa.BWD_Q_TILE[shape[-1]])
        di_rel = float((di - di_ref).abs().max() / di_ref.abs().max())
        lse2_same = bool(torch.equal(lse2, lse2_ref))
        post_same = bool(torch.equal(grads[0], fa.flash_attention_dq_postprocess_reference(dq_accum, scale, shape[1])))
        dkv_bitwise = bool(torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2]))
        accum_run = float((dq_accum - accum_again).abs().max() / dq_accum.abs().max())
        dq_ulp = within_bf16_ulp(grads[0], again[0], FLASH_DQ_RUN_TOL * float(grads[0].float().abs().max()))
        log("kernel-check", kernel="flash_attn_bwd", shape=list(shape), lk=kv_shape[1], q_scale=q_scale,
            rel_err=rel, max_abs_err=max(float((a.float() - r).abs().max()) for a, r in zip(grads, refs)),
            rel_tol=FLASH_BWD_REL_TOL, lse_max_abs_err=lse_err, lse_tol=FLASH_LSE_TOL, fwd_same_with_lse=same_out,
            pre_di_rel_err=di_rel, pre_di_tol=FLASH_DI_REL_TOL, pre_lse_same=lse2_same, post_same=post_same,
            run_to_run_dk_dv_bitwise=dkv_bitwise, run_to_run_dq_accum_rel=accum_run,
            run_to_run_dq_accum_tol=FLASH_DQ_RUN_TOL, run_to_run_dq_within_bf16_ulp=dq_ulp,
            run_to_run_dq_rel=float((grads[0].float() - again[0].float()).abs().max() / grads[0].float().abs().max()))
        if not (max(rel.values()) < FLASH_BWD_REL_TOL and lse_err < FLASH_LSE_TOL and same_out):
            raise AssertionError(f"flash_attn_bwd disagrees with its plain version: {rel}, lse {lse_err}, {same_out}")
        if not (di_rel <= FLASH_DI_REL_TOL and lse2_same and post_same):
            raise AssertionError(f"flash_attn_bwd pre/post kernels: Di {di_rel}, lse {lse2_same}, dq {post_same}")
        if not (dkv_bitwise and accum_run <= FLASH_DQ_RUN_TOL and dq_ulp):
            raise AssertionError(f"flash_attn_bwd run to run: dk/dv bitwise {dkv_bitwise}, dq workspace {accum_run}, "
                                 f"dq within a bf16 ulp {dq_ulp}")
        errs.append(max(float((a.float() - r).abs().max()) for a, r in zip(grads, refs)))
        del refs, grads, again, lse_ref, di_ref, lse2_ref, dq_accum, accum_again
    times = {}
    for shape in (MAIN_SHAPE, LEVEL32_SHAPE, D128_SHAPE):
        q, k, v, do = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention_with_lse(q, k, v)
        ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, do))
        split = bwd_launch_split_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, do))
        plain_ms = time_ms(lambda: fa.flash_attention_backward_reference(q, k, v, out, lse, do), iters=5, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v))
        fwd_lse_ms = time_ms(lambda: fa.flash_attention_with_lse(q, k, v))
        bound, bound_by = flash_bwd_bound_ms(shape)
        B, L, Hh, D = shape
        times[shape] = (ms, plain_ms, library_ms, bound, bound_by)
        log("kernel-time", kernel="flash_attn_bwd", shape=list(shape), ms=ms,
            ms_note="the wrapper: preprocess + main + postprocess", launch_split_ms=split,
            plain_ms=plain_ms, sdpa_bwd_ms=library_ms, bound_ms=bound, share_of_bound=bound / ms,
            tflops_of_bound_work=5 * 2.0 * B * Hh * L * L * D / ms / 1e9, fwd_ms=fwd_ms, fwd_with_lse_ms=fwd_lse_ms,
            key_blocks=-(-L // 128) * Hh * B,
            waves=-(-L // 128) * Hh * B / torch.cuda.get_device_properties(0).multi_processor_count)
        del sdpa_out, qt, kt, vt
    q = torch.randn(MAIN_SHAPE, device=dev, dtype=torch.bfloat16)
    log("kernel-host", kernel="flash_attn_bwd", what="TMA descriptor encoding per call (4 maps: q, k, v, dO)",
        us=fa.encode_us_bwd(q, q, q, q))
    ms, plain_ms, library_ms, bound, bound_by = times[MAIN_SHAPE]
    return dict(
        name="flash_attn_bwd", route="cuda", source="voxe_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:254 (via voxe_tpu/models/sd/unet.py:163)",
        launches=0, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
        library_ms=library_ms,
    )


def composite_inputs(g, n, s, sigma_max, dev):
    """sigma ~ U[0, sigma_max), sorted depths in [2, 6), |dir| ~ U[0.9, 1.4)."""
    dens = torch.rand((n, s), generator=g, device=dev) * sigma_max
    depths = torch.sort(torch.rand((n, s), generator=g, device=dev) * 4.0 + 2.0, dim=-1).values
    dirn = torch.rand((n,), generator=g, device=dev) * 0.5 + 0.9
    return dens, depths, dirn


CHECKED_SHAPES = set()  # [N, S] the compositing kernel was held at


def hold_composite(args, name: str) -> float:
    """The kernel against its plain version on `args`; returns the larger
    error (weights, acc), failing above COMPOSITE_TOL."""
    w, acc = comp.composite_weights(*args)
    torch.cuda.synchronize()
    wr, ar = comp.composite_weights_reference(*args)
    ew, ea = float((w - wr).abs().max()), float((acc - ar).abs().max())
    log("kernel-check", kernel="composite_fwd", case=name, shape=list(args[0].shape), max_abs_err_w=ew,
        max_abs_err_acc=ea, tol=COMPOSITE_TOL, acc_min=float(acc.min()), acc_max=float(acc.max()))
    if not (ew <= COMPOSITE_TOL and ea <= COMPOSITE_TOL and torch.isfinite(w).all()):
        raise AssertionError(f"composite_fwd disagrees with its plain version on {name}: {ew}, {ea}")
    CHECKED_SHAPES.add(tuple(args[0].shape))
    return max(ew, ea)


def composite_bound_ms(n: int, s: int) -> float:
    """Bytes: read sigma and depth, write w (12 B a sample); read |dir|,
    write acc (8 B a ray). The few flops a sample are far below the byte time."""
    return (12.0 * n * s + 8.0 * n) / H100_BYTES_PER_S * 1e3


def phase_composite_kernel(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(1)
    # the main shapes the driven paths launch at: 160 slices slab-padded to
    # 256 as accumulate pads them, on the recon step's 768^2 base, the edit
    # step's and the refinement's 384^2 base, the CLIs' 800^2 feedback base
    # (2x the 400^2 screen) and the shear-warp turntable's 1600^2 base (2x
    # its 800^2 screen); the held-out render chunk; the exact chunk at 512
    # samples a ray (the segment CLI's feedback, the exact turntable);
    # ragged; dense (T underflows to 0 within the first ~130 of 512
    # samples). The shape-sweep phase checks every other shape the run
    # launched.
    def slab_padded(n):
        dens, depths, dirn = composite_inputs(g, n, GRID_RES, 5.0, dev)
        return _pad_samples(dens, depths, "slab")[:2] + (dirn,)

    cases = {
        "recon_step_slab_padded": slab_padded(RECON_BASE * RECON_BASE),
        "edit_step_slab_padded": slab_padded(BASE * BASE),
        "edit_feedback_slab_padded": slab_padded((2 * SCENE) ** 2),
        "turntable_slab_padded": slab_padded((4 * SCENE) ** 2),
        "heldout_chunk": composite_inputs(g, 32768, 1024, 5.0, dev),
        "exact_feedback_chunk": composite_inputs(g, 32768, 512, 5.0, dev),
        "ragged": composite_inputs(g, 1000, 37, 5.0, dev),
        "dense_underflow": composite_inputs(g, 2048, 512, 50.0, dev),
    }
    errs = [hold_composite(args, name) for name, args in cases.items()]
    times = {}
    for name in ("recon_step_slab_padded", "heldout_chunk", "turntable_slab_padded"):
        args = cases[name]
        n, s = args[0].shape
        ms = time_ms(lambda: comp.composite_weights(*args))
        plain_ms = time_ms(lambda: comp.composite_weights_reference(*args), iters=5, warmup=1)
        bound = composite_bound_ms(n, s)
        times[name] = (ms, plain_ms, bound)
        log("kernel-time", kernel="composite_fwd", case=name, shape=[n, s], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, share_of_bound=bound / ms, gbytes_per_s=(12.0 * n * s + 8.0 * n) / ms / 1e6)
    del cases
    torch.cuda.empty_cache()
    ms, plain_ms, bound = times["recon_step_slab_padded"]
    return dict(
        name="composite_fwd", route="cuda", source="voxe_tpu_torch/csrc/composite_fwd.cu",
        replaces="voxe_tpu/ops/composite.py:91", launches=0, max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None,
    )


def make_grid(res: int, dev, seed: int = 0) -> VoxelGrid:
    """The benchmark grid recipe (bench.py make_dog2_grid): softplus field,
    bf16 resample table, reference density scale, uniform(-1, 1) values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    config = VoxelGridConfig(
        voxel_size=VoxelSize(*[3.0 / res] * 3),
        density_preactivation="identity", density_postactivation="softplus",
        gather_dtype="bfloat16",
        expected_density_scale=compute_expected_density_scale_for_relu_field_grid((3.0, 3.0, 3.0)),
    )
    dens = torch.rand((res, res, res, 1), generator=g, device=dev) * 2 - 1
    feats = torch.rand((res, res, res, 3), generator=g, device=dev) * 2 - 1
    return VoxelGrid(densities=dens, features=feats, config=config)


RCFG = SHVoxGridRenderConfig(num_samples_per_ray=256, camera_bounds=CameraBounds(2.0, 6.0), white_bkgd=True)


def phase_small_check(dev) -> None:
    """Tiny edit step, f32: card vs CPU on the same weights and draws."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads = {}
    pose = pose_spherical(40.0, 60.0, 4.0311)
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
    cpu_sd = StableDiffusion("tiny", unet_dtype=torch.float32, device="cpu", seed=3)
    state = {n: getattr(cpu_sd, n).state_dict() for n in ("clip", "vae", "unet")}
    for d in ("cpu", dev):
        sd = cpu_sd if d == "cpu" else StableDiffusion("tiny", unet_dtype=torch.float32, device=d)
        if d != "cpu":
            for n, s in state.items():
                getattr(sd, n).load_state_dict(s)
        grid = make_grid(16, "cpu", seed=1)
        grid = grid.replace(
            densities=grid.densities.to(d).requires_grad_(True),
            features=grid.features.to(d).requires_grad_(True),
            config=dataclasses.replace(grid.config, gather_dtype="float32"),
        )
        total, _ = train_sds.sds_edit_loss(
            grid, sd, RCFG, (24, 24), sd.get_text_embeds("a dog, side view"),
            torch.as_tensor(pose.rotation, device=d), torch.as_tensor(pose.translation, device=d),
            grid.densities.detach() * 0.9, grid.features.detach(), 500,
            density_correlation_weight=200.0, noise=noise, vae_eps=eps,
        )
        total.backward()
        grads[str(d)] = torch.cat([grid.densities.grad.flatten(), grid.features.grad.flatten()]).cpu()
    ref, got = grads["cpu"], grads[str(dev)]
    rel = float((got - ref).abs().max() / ref.abs().max())
    log("small-check", what="tiny edit-step grid gradient, card vs CPU (f32)", rel_err=rel, tol=1e-3)
    if not (torch.isfinite(got).all() and rel < 1e-3):
        raise AssertionError(f"small-input edit step disagrees with the CPU: {rel}")
    torch.backends.cudnn.allow_tf32 = True  # the library default, back for the main path


def phase_main(dev) -> tuple:
    """The edit main path at full width; returns its (flash, compositing)
    launches."""
    t0 = time.perf_counter()
    sd = StableDiffusion(SD_VERSION, init_mode="random", seed=0, device=dev)
    text_by_dir = torch.stack([sd.get_text_embeds(f"a dog made of yarn, {d} view") for d in DIRECTION_PROMPTS])
    grid = make_grid(GRID_RES, dev)
    ref_d, ref_f = grid.densities.clone(), grid.features.clone()
    opt = train_sds.make_adam(grid, 0.03)
    multi = train_sds.make_sds_train_multi_step(
        sd, RCFG, opt, CameraIntrinsics(BASE, BASE, float(BASE)), STEPS_PER_CALL,
        density_correlation_weight=200.0, guidance_scale=100.0,
        use_shear_warp=True, sw_base_hw=(BASE, BASE),
    )
    t_bounds = torch.tensor([[500, 500]] * STEPS_PER_CALL)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    log("main-setup", sd=SD_VERSION, unet_dtype="bfloat16", grid=GRID_RES, base=BASE, setup_s=time.perf_counter() - t0)

    before = grid.densities.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts from here to the end of the edit path's run
    m = multi(grid, text_by_dir, ref_d, ref_f, t_bounds, gen)  # warm-up call
    torch.cuda.synchronize()
    losses, call_ms = [float(m["total_loss"])], []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        m = multi(grid, text_by_dir, ref_d, ref_f, t_bounds, gen)
        losses.append(float(m["total_loss"]))  # reads the loss: a device sync
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3 / STEPS_PER_CALL)
    launches, composite_launches = fa.LAUNCHES, comp.LAUNCHES
    steps = STEPS_PER_CALL * (1 + TIMED_CALLS)
    ms_step = float(np.median(call_ms))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    moved = float((grid.densities.detach() - before).abs().max())
    log("main-path", steps=steps, ms_per_step_median=ms_step, ms_per_step_min=min(call_ms),
        ms_per_step_max=max(call_ms), timed_calls=TIMED_CALLS, peak_mem_gib=peak_gib,
        flash_launches=launches, composite_launches=composite_launches, losses=losses, grid_max_change=moved)
    if launches != 5 * steps:
        raise AssertionError(f"flash kernel launched {launches} times in {steps} steps, want 5 per step")
    if not all(np.isfinite(losses)) or not moved > 0.0:
        raise AssertionError(f"main path: losses {losses}, grid change {moved}")
    breakdown(sd, grid, text_by_dir[3], ref_d)
    profile_call(lambda: multi(grid, text_by_dir, ref_d, ref_f, t_bounds, gen), STEPS_PER_CALL, ms_step)
    return launches, composite_launches


BWD_IN_PHASE = 0  # backward launches in the running phase, across its count resets


def reset_counts() -> None:
    global BWD_IN_PHASE
    BWD_IN_PHASE += fa.LAUNCHES_BWD
    fa.reset_launches()
    comp.reset_launches()


def profile_call(fn, steps: int, ms_step: float) -> None:
    """Device busy time and top kernels of one multi-step call under
    torch.profiler. The profiler's own overhead inflates its wall time, so
    the idle share is also given against the unprofiled `ms_step`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(k[1] for k in kernels)
    if busy_ms == 0.0:
        log("profile", device_time="not measured (profiler saw no device time)")
        return
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    ours = {n: sum(t for key, t, _ in kernels if n in key) / steps for n in ("flash_fwd_kernel", "composite_fwd_kernel")}
    log("profile", steps=steps, wall_ms_per_step=wall_ms / steps, device_busy_ms_per_step=busy_ms / steps,
        idle_share_profiled=1.0 - busy_ms / wall_ms,
        idle_share_vs_unprofiled_step=1.0 - busy_ms / steps / ms_step,
        kernel_launches_per_step=sum(k[2] for k in kernels) / steps,
        flash_ms_per_step=ours["flash_fwd_kernel"], composite_ms_per_step=ours["composite_fwd_kernel"])
    print("[profile-top] " + json.dumps(
        [{"kernel": k[:90], "ms_per_step": t / steps, "calls_per_step": c / steps} for k, t, c in top]
    ), flush=True)


def clocked(parts: dict, name: str, fn):
    """Run fn between two device syncs; append its ms to parts[name]."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    parts.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    return out


def breakdown(sd, grid, text, ref_d) -> None:
    """Per-layer device time of one edit step at a fixed pose, with a
    synchronised host clock around each layer (median of 3)."""
    pose = pose_spherical(30.0, 40.0, 4.0311)
    rot = torch.as_tensor(pose.rotation, device=grid.densities.device)
    cam = CameraPose(rot, torch.as_tensor(pose.translation, device=rot.device))
    gen = torch.Generator(device=rot.device).manual_seed(2)
    parts = {}

    def clock(name, fn):
        return clocked(parts, name, fn)

    for _ in range(4):
        g = grid.replace(densities=grid.densities.detach().requires_grad_(True),
                         features=grid.features.detach().requires_grad_(True))
        out = clock("render_fwd", lambda: render_shear_warp(g, cam, RCFG, base_hw=(BASE, BASE))[0])
        img = orient_base_image(out.colour.reshape(BASE, BASE, 3), rot)[None]
        lat = clock("resize_vae_encode_fwd", lambda: sd.encode_imgs(F.interpolate(
            img.permute(0, 3, 1, 2), size=(sd.config.image_size,) * 2, mode="bilinear", antialias=True), None))
        noisy = sd.scheduler.add_noise(lat.detach(), torch.randn(lat.shape, generator=gen, device=lat.device), 500)
        clock("unet_cfg_fwd", lambda: sd.unet_noise_pred(torch.cat([noisy] * 2), 500, text))
        loss = (lat * torch.randn(lat.shape, generator=gen, device=lat.device)).sum()
        loss = loss + 200.0 * density_correlation_loss(g.densities, ref_d)[0]
        clock("backward_vae_render_dcl", loss.backward)
    med = {k: float(np.median(v[1:])) for k, v in parts.items()}
    log("breakdown", **{f"{k}_ms": v for k, v in med.items()})


def make_recon_grid(res: int, dev, seed: int = 0, gather_dtype: str = "bfloat16", sh_degree: int = 0):
    """The recon CLI's grid: softplus field at the reference density scale,
    SH features, uniform(-1, 1) values (the trainer's initial draw)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    config = VoxelGridConfig(
        voxel_size=VoxelSize(*[3.0 / res] * 3),
        density_preactivation="identity", density_postactivation="softplus", gather_dtype=gather_dtype,
        expected_density_scale=compute_expected_density_scale_for_relu_field_grid((3.0, 3.0, 3.0)),
    )
    dens = torch.rand((res, res, res, 1), generator=g, device=dev) * 2 - 1
    feats = torch.rand((res, res, res, 3 * (sh_degree + 1) ** 2), generator=g, device=dev) * 2 - 1
    return VoxelGrid(densities=dens, features=feats, config=config)


def phase_small_check_recon(dev) -> None:
    """16^3 shear-warp recon step with the fused compositing kernel, f32, SH
    degree 1: its grid gradient on the card against the same step on the CPU
    (the plain version there)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    base = (40, 40)
    targets = torch.from_numpy(rng.uniform(0, 1, (2, *base, 3)).astype(np.float32))
    masks = torch.from_numpy((rng.random((2, *base)) > 0.2).astype(np.float32))
    pose = pose_spherical(70.0, 50.0, 4.0311)
    poses = torch.from_numpy(np.stack([np.concatenate([pose.rotation, pose.translation], 1)] * 2))
    grads, launches = {}, 0
    for d in ("cpu", dev):
        grid = make_recon_grid(16, "cpu", seed=4, gather_dtype="float32", sh_degree=1)
        grid = grid.replace(densities=grid.densities.to(d), features=grid.features.to(d))
        opt = train_sds.make_adam(grid, 0.03)
        step = train_recon.make_recon_train_step_shearwarp(RECON_RCFG, opt, base, True)
        before = comp.LAUNCHES
        step(grid, targets.to(d), masks.to(d), poses.to(d), 1)
        launches = comp.LAUNCHES - before
        grads[str(d)] = torch.cat([grid.densities.grad.flatten(), grid.features.grad.flatten()]).cpu()
    ref, got = grads["cpu"], grads[str(dev)]
    rel = float((got - ref).abs().max() / ref.abs().max())
    log("small-check", what="16^3 shear-warp recon step grid gradient, card vs CPU (f32, fused kernel)",
        rel_err=rel, tol=1e-4, card_composite_launches=launches)
    if not (torch.isfinite(got).all() and rel < 1e-4 and launches == 2):
        raise AssertionError(f"small-input recon step disagrees with the CPU: {rel}, launches {launches}")


def phase_recon_main(dev, workdir: Path) -> tuple:
    """The recon main path at full width; returns its (flash, compositing)
    launches and the trained state (grid, optimizer, config, base targets) that the
    recon-kstep phase continues from."""
    t0 = time.perf_counter()
    scene = workdir / "scene"
    generate_synthetic_scene(scene, num_train=8, num_test=2, image_size=SCENE, focal=float(SCENE),
                             device=dev, use_fused_kernel=True)
    for split in ("train", "test"):  # the CLI's default split layout, for the CLI phase
        (scene / split).mkdir()
        for p in sorted((scene / "images").glob(f"{split}_*.png")):
            p.rename(scene / split / p.name)
    train = PosedImagesDataset(scene / "train", scene / "train_camera_params.json", rgba_white_bkgd=True, device=dev)
    test = PosedImagesDataset(scene / "test", scene / "test_camera_params.json", rgba_white_bkgd=True, device=dev)
    images, poses = train.device_arrays()
    grid = make_recon_grid(GRID_RES, dev)
    base_hw = (RECON_BASE, RECON_BASE)
    targets, masks = train_recon.warp_dataset_to_base(images, poses, train.camera_intrinsics, grid, base_hw)
    rcfg = RECON_RCFG.replace(camera_bounds=train.camera_bounds)
    opt = train_sds.make_adam(grid, 0.03)
    step = train_recon.make_recon_train_step_shearwarp(
        rcfg, opt, base_hw, True, lr_schedule=train_recon.exponential_decay_staircase(0.03, 400, 0.1)
    )
    rng = np.random.default_rng(42)
    torch.cuda.synchronize()
    log("recon-setup", scene=f"{SCENE}x{SCENE}", train_images=len(train), test_images=len(test), grid=GRID_RES,
        base=RECON_BASE, rays_per_step=RECON_BASE**2, slices=GRID_RES, target_coverage=float(masks.mean()),
        setup_s=time.perf_counter() - t0)

    before = grid.densities.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts from here to the end of the recon path's run
    m = step(grid, targets, masks, poses, int(rng.integers(0, len(train))))  # warm-up call
    losses, step_ms = [float(m["total_loss"])], []
    for _ in range(RECON_TIMED_STEPS):
        t1 = time.perf_counter()
        m = step(grid, targets, masks, poses, int(rng.integers(0, len(train))))
        losses.append(float(m["total_loss"]))  # reads the loss: a device sync
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    steps = 1 + RECON_TIMED_STEPS
    train_launches, flash_launches = comp.LAUNCHES, fa.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    moved = float((grid.densities.detach() - before).abs().max())
    ms_step = float(np.median(step_ms))
    log("recon-main-path", steps=steps, ms_per_step_median=ms_step, ms_per_step_min=min(step_ms),
        ms_per_step_max=max(step_ms), timed_steps=RECON_TIMED_STEPS, rays_per_s=RECON_BASE**2 / ms_step * 1e3,
        peak_mem_gib=peak_gib, composite_launches=train_launches, flash_launches=flash_launches,
        losses=losses, grid_max_change=moved)
    if train_launches != 2 * steps or flash_launches != 0:
        raise AssertionError(f"composite kernel launched {train_launches} times in {steps} steps, want 2 per step")
    if not all(np.isfinite(losses)) or not moved > 0.0:
        raise AssertionError(f"recon path: losses {losses}, grid change {moved}")

    # held-out evaluation with the exact renderer (the kernel's route 2)
    model = VolumetricModel(grid.replace(densities=grid.densities.detach(), features=grid.features.detach()), rcfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = test_sh_vox_grid_vol_mod_with_posed_images(model, test)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) * 1e3 / len(test)
    eval_launches = comp.LAUNCHES - train_launches
    log("recon-heldout", images=len(test), psnr=metrics["psnr"], ssim=metrics["ssim"], ms_per_image=eval_ms,
        composite_launches=eval_launches, samples_per_ray=rcfg.render_num_samples_per_ray,
        chunk=rcfg.parallel_rays_chunk_size)
    if eval_launches != 5 * len(test) or not np.isfinite(metrics["psnr"]):
        raise AssertionError(f"held-out render: {eval_launches} launches for {len(test)} images, want 5 each")
    total_launches = fa.LAUNCHES, comp.LAUNCHES
    recon_breakdown(grid, opt, rcfg, targets, masks, poses, base_hw)
    profile_call(lambda: step(grid, targets, masks, poses, 0), 1, ms_step)
    context = dict(grid=grid, opt=opt, rcfg=rcfg, targets=targets, masks=masks, poses=poses, base_hw=base_hw,
                   num_images=len(train))
    return total_launches, context


RECON_K, RECON_K_ROUNDS = 10, 2


def phase_recon_kstep(ctx: dict) -> tuple:
    """The recon main path's configuration at K = 10 steps a call against
    K = 1, as the trainer runs them: each call draws its image indices on
    the host and ends in a loss read (the summary's sync). Two rounds, each
    one K = 10 call and ten K = 1 calls; returns the (flash, compositing)
    launches."""
    grid, opt = ctx["grid"], ctx["opt"]
    args = (ctx["targets"], ctx["masks"], ctx["poses"])
    schedule = train_recon.exponential_decay_staircase(0.03, 400, 0.1)
    multi = {k: train_recon.make_recon_train_multi_step_shearwarp(ctx["rcfg"], opt, ctx["base_hw"], k, True,
                                                                  lr_schedule=schedule) for k in (1, RECON_K)}
    rng = np.random.default_rng(7)
    torch.cuda.synchronize()
    reset_counts()  # counts from here to the end of this path's run
    ms = {1: [], RECON_K: []}
    losses = []
    for _ in range(RECON_K_ROUNDS):
        for k, calls in ((RECON_K, 1), (1, RECON_K)):
            t0 = time.perf_counter()
            for _ in range(calls):
                m = multi[k](grid, *args, rng.integers(0, ctx["num_images"], k))
                losses.append(float(m["total_loss"]))  # the summary's device sync
            ms[k].append((time.perf_counter() - t0) * 1e3 / (calls * k))
    launches, flash = comp.LAUNCHES, fa.LAUNCHES
    steps = 2 * RECON_K_ROUNDS * RECON_K
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log("recon-kstep", k=RECON_K, steps=steps, ms_per_step_k10=med[RECON_K], ms_per_step_k1=med[1],
        ms_per_step_k10_rounds=ms[RECON_K], ms_per_step_k1_rounds=ms[1],
        steps_per_s_k10=1e3 / med[RECON_K], steps_per_s_k1=1e3 / med[1],
        ratio_k10_over_k1=med[RECON_K] / med[1], composite_launches=launches, flash_launches=flash,
        losses_finite=bool(np.isfinite(losses).all()))
    if launches != 2 * steps or flash != 0 or not np.isfinite(losses).all():
        raise AssertionError(f"recon-kstep: {launches} compositing launches for {steps} steps, want 2 a step")
    return flash, launches


def recon_breakdown(grid, opt, rcfg, targets, masks, poses, base_hw) -> None:
    """Per-layer time of the recon step with a synchronised host clock
    around each layer (median of 3 after one warm-up)."""
    parts = {}
    for i in range(4):
        idx = i % poses.shape[0]
        pose = CameraPose(rotation=poses[idx][:, :3], translation=poses[idx][:, 3:])
        m = masks[idx][..., None]
        denom = torch.clamp(masks[idx].sum() * 3, min=1.0)
        opt.zero_grad(set_to_none=True)
        out = clocked(parts, "render_fwd", lambda: render_shear_warp(
            grid, pose, rcfg, base_hw=base_hw, with_diffuse=True)[0])
        total = clocked(parts, "loss", lambda: train_recon.photometric_losses(
            out.colour.reshape(*base_hw, 3), out.extra["diffuse_colour"].reshape(*base_hw, 3),
            targets[idx], True, mask=m, denom=denom)[0])
        clocked(parts, "backward", total.backward)
        clocked(parts, "adam", opt.step)
    med = {k: float(np.median(v[1:])) for k, v in parts.items()}
    log("recon-breakdown", **{f"{k}_ms": v for k, v in med.items()})


class LogRecords(logging.Handler):
    """Keeps the port's log records (the editing loop logs its training time)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def logged(fn, *args, **kwargs):
    """Run fn(*args, **kwargs) keeping the port's log records; returns (its
    result, the records)."""
    records = LogRecords()
    port_log = logging.getLogger("voxe_tpu_torch")
    port_log.setLevel(logging.INFO)
    port_log.addHandler(records)
    try:
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        port_log.removeHandler(records)
    return out, records.records


RECON_CLI_STAGES, RECON_CLI_ITERS = 4, 3


def write_random_lpips_weights(root: Path) -> Path:
    """Seeded random LPIPS-VGG weights in the layout the port loads:
    torchvision's `vgg16.pth` (conv weights scaled by 0.3, so that 13
    stacked random convs stay finite) and the lpips heads `lpips_vgg.pth`."""
    root.mkdir(parents=True, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        feats = build_vgg16_features()
        with torch.no_grad():
            for m in feats:
                if hasattr(m, "weight"):
                    m.weight.mul_(0.3)
        heads = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1) * 0.1
                 for i, c in enumerate((64, 128, 256, 512, 512))}
    torch.save({f"features.{k}": v for k, v in feats.state_dict().items()}, root / "vgg16.pth")
    torch.save(heads, root / "lpips_vgg.pth")
    return root


def phase_recon_cli(workdir: Path) -> tuple:
    """The recon CLI module end to end at its default flags: 4 stages (20^3
    .. 160^3 grids on 50^2 .. 400^2 images) of a few shear-warp iterations
    with the fused kernel, the camera rays, feedback and held-out tests (with
    LPIPS on seeded random weights through $VOXE_LPIPS_WEIGHTS_DIR), ending
    in model_final.pth; returns its (flash, compositing) launches."""
    out = workdir / "cli_out"
    lpips_dir = write_random_lpips_weights(workdir / "lpips")
    t0 = time.perf_counter()
    reset_counts()  # counts from here to the end of the recon CLI's run
    os.environ["VOXE_LPIPS_WEIGHTS_DIR"] = str(lpips_dir)
    try:
        _, records = logged(recon_cli.main, [
            "-d", str(workdir / "scene"), "-o", str(out), "--num_stages", str(RECON_CLI_STAGES),
            "--num_iterations_per_stage", str(RECON_CLI_ITERS), "--use_fused_kernel", "True", "--device", "cuda",
        ])
    finally:
        del os.environ["VOXE_LPIPS_WEIGHTS_DIR"]
    launches, flash = comp.LAUNCHES, fa.LAUNCHES
    seconds = time.perf_counter() - t0
    model, info = load_volumetric_model(out / "saved_models" / "model_final.pth", device="cuda")
    dens = model.grid.densities
    # the JAX trainer's cadence at feedback 100 / test 250 with 3 iterations a
    # stage: feedback on each stage's first and last iteration (colour and
    # diffuse PNGs), the held-out test on each stage's last
    steps = RECON_CLI_STAGES * RECON_CLI_ITERS
    feedback_steps = sorted({s * RECON_CLI_ITERS + i for s in range(RECON_CLI_STAGES) for i in (1, RECON_CLI_ITERS)})
    pngs = [out / "training_logs" / "rendered_output" / f"default_{kind}iter_{g}.png"
            for g in feedback_steps for kind in ("", "diffuse_")]
    tests = [(r.global_step, r.test_metrics) for r in records if hasattr(r, "test_metrics")]
    stages = [r for r in records if hasattr(r, "stage_training_s")]
    test_images = len(list((workdir / "scene" / "test").glob("*.png")))
    want = 2 * steps + len(pngs) + -(-SCENE**2 // 32768) * test_images * RECON_CLI_STAGES
    log("recon-cli", stages=RECON_CLI_STAGES, iterations_per_stage=RECON_CLI_ITERS, seconds=seconds,
        camera_rays_png=(out / "camera_rays.png").exists(), feedback_pngs=sum(p.exists() for p in pngs),
        feedback_pngs_jax_cadence=len(pngs), feedback_steps=feedback_steps,
        heldout=[{"step": g, **m} for g, m in tests],
        stage_training_s=[r.stage_training_s for r in stages], stage_feedback_s=[r.stage_feedback_s for r in stages],
        stage_test_s=[r.stage_test_s for r in stages], composite_launches=launches, composite_launches_want=want,
        flash_launches=flash, final_grid=list(model.grid.grid_dims), finite=bool(torch.isfinite(dens).all()),
        hemispherical_radius=info.get("hemispherical_radius"))
    if model.grid.grid_dims != (GRID_RES,) * 3 or not torch.isfinite(dens).all():
        raise AssertionError("recon CLI: model_final.pth does not hold a finite 160^3 grid")
    if not (out / "camera_rays.png").exists() or not all(p.exists() for p in pngs):
        raise AssertionError("recon CLI: camera_rays.png or feedback PNGs missing")
    if [g for g, _ in tests] != [(s + 1) * RECON_CLI_ITERS for s in range(RECON_CLI_STAGES)] or not all(
            np.isfinite(m["psnr"]) and 0.0 < m["ssim"] <= 1.0 and np.isfinite(m.get("lpips", np.nan))
            for _, m in tests):
        raise AssertionError(f"recon CLI: held-out tests {tests}")
    if launches != want or flash != 0:
        raise AssertionError(f"recon CLI: {launches} compositing launches, want {want}; {flash} flash")
    return flash, launches


RESUME_ITERS, RESUME_MORE = 12, 22  # 10 + 2 steps a stage; the resumed run adds a call of 10 and one of 1


def heldout_launches(workdir: Path, tests: int) -> int:
    """Compositing launches of `tests` held-out tests: 5 a 400^2 image."""
    return -(-SCENE**2 // 32768) * len(list((workdir / "scene" / "test").glob("*.png"))) * tests


def phase_recon_cli_resume(workdir: Path) -> tuple:
    """The recon CLI at its defaults with --steps_per_call 10 (4 stages of
    12 iterations: a call of 10 and one of 2 a stage), then --resume from
    the training_state_latest.pth it wrote with 22 iterations a stage: the
    ladder fast-forwards to stage 4 and continues after the saved iteration
    (the first iteration of the saved call, as the JAX trainer records it).
    Returns both runs' (flash, compositing) launches."""
    out, resumed = workdir / "cli_k10", workdir / "cli_k10_resumed"
    base = ["-d", str(workdir / "scene"), "--num_stages", str(RECON_CLI_STAGES), "--steps_per_call", "10",
            "--use_fused_kernel", "True", "--device", "cuda"]
    reset_counts()  # counts from here to the end of both runs
    t0 = time.perf_counter()
    _, records = logged(recon_cli.main, base + ["-o", str(out), "--num_iterations_per_stage", str(RESUME_ITERS)])
    first_s, first_launches = time.perf_counter() - t0, comp.LAUNCHES
    state = out / "saved_models" / "training_state_latest.pth"
    _, meta = read_training_state(state)
    stages = [r for r in records if hasattr(r, "stage_training_s")]
    t0 = time.perf_counter()
    _, records2 = logged(recon_cli.main, base + ["-o", str(resumed), "--num_iterations_per_stage", str(RESUME_MORE),
                                                 "--resume", str(state)])
    resumed_s, launches, flash = time.perf_counter() - t0, comp.LAUNCHES, fa.LAUNCHES
    stages2 = [r for r in records2 if hasattr(r, "stage_training_s")]
    arrays2, meta2 = read_training_state(resumed / "saved_models" / "training_state_latest.pth")
    # first run: 2 steps an iteration; feedback on each stage's first and last
    # call (2 renders each); the held-out test at each stage's end
    steps = RECON_CLI_STAGES * RESUME_ITERS
    want_first = 2 * steps + 4 * RECON_CLI_STAGES + heldout_launches(workdir, RECON_CLI_STAGES)
    resumed_steps = RESUME_MORE - meta["stage_iteration"]
    want_resumed = 2 * resumed_steps + 2 + heldout_launches(workdir, 1)
    snapshots = sorted(p.name for p in (resumed / "saved_models").glob("model_stage_*"))
    log("recon-cli-resume", steps_per_call=10, first_run_s=first_s, first_run_steps=steps,
        first_stage_training_s=[r.stage_training_s for r in stages],
        last_stage_ms_per_step=stages[-1].stage_training_s / RESUME_ITERS * 1e3, saved=meta, resumed_s=resumed_s,
        resumed_stages=[r.stage for r in stages2], resumed_state=meta2, resumed_steps=resumed_steps,
        resumed_adam_count=int(arrays2["opt_state/0/count"]), resumed_snapshots=snapshots,
        composite_launches_first=first_launches, composite_launches_resumed=launches - first_launches,
        flash_launches=flash)
    if (meta["stage"], meta["global_step"]) != (RECON_CLI_STAGES, steps) or [r.stage for r in stages2] != [
            RECON_CLI_STAGES]:
        raise AssertionError(f"recon-cli-resume: saved {meta}, resumed stages {[r.stage for r in stages2]}")
    if meta2["global_step"] != steps + resumed_steps or int(arrays2["opt_state/0/count"]) != (
            RESUME_ITERS + resumed_steps):
        raise AssertionError(f"recon-cli-resume: resumed state {meta2}")
    if (first_launches, launches - first_launches, flash) != (want_first, want_resumed, 0):
        raise AssertionError(f"recon-cli-resume: launches {first_launches}, {launches - first_launches}, flash "
                             f"{flash}; want {want_first}, {want_resumed}, 0")
    model, _ = load_volumetric_model(resumed / "saved_models" / "model_final.pth", device="cuda")
    if model.grid.grid_dims != (GRID_RES,) * 3 or not torch.isfinite(model.grid.densities).all():
        raise AssertionError("recon-cli-resume: the resumed model_final.pth holds no finite 160^3 grid")
    return flash, launches


STREAM_ITERS = 12


def phase_recon_streaming(dev, workdir: Path) -> tuple:
    """One stage of the 400^2 scene through the trainer on the exact route
    at the recon CLI's final-stage settings (160^3, 32,768 rays of 256
    samples a step): RAM-backed, then memmap-backed (`cache_backing=
    "memmap"`, pixels gathered on the host every step), then RAM-backed
    again. The exact ray-batch step composites with the plain accumulate,
    as the JAX step does (its render takes no fused-kernel branch), so the
    compositing kernel launches 0 times here. ms/step is each stage's synced
    training time over its steps, the first step's warm-up included.
    Returns the (flash, compositing) launches of the three runs."""
    scene = workdir / "scene"
    runs = {}
    reset_counts()  # counts from here to the end of the three runs
    for name, backing in (("ram", "ram"), ("memmap", "memmap"), ("ram_again", "ram")):
        ds = PosedImagesDataset(scene / "train", scene / "train_camera_params.json", rgba_white_bkgd=True,
                                device=dev, cache_backing=backing)
        model = VolumetricModel(make_recon_grid(GRID_RES, dev), RECON_RCFG.replace(camera_bounds=ds.camera_bounds))
        before = comp.LAUNCHES
        out, records = logged(lambda: train_recon.train_sh_vox_grid_vol_mod_with_posed_images(
            model, ds, workdir / f"stream_{name}", num_stages=1, num_iterations_per_stage=STREAM_ITERS,
            ray_batch_size=32768, image_batch_cache_size=8, fast_debug_mode=True))
        stage = next(r for r in records if hasattr(r, "stage_training_s"))
        runs[name] = dict(streaming=ds.streaming, ms_per_step=stage.stage_training_s / STREAM_ITERS * 1e3,
                          composite_launches=comp.LAUNCHES - before,
                          finite=bool(torch.isfinite(out.grid.densities).all()))
    log("recon-streaming", iterations=STREAM_ITERS, rays_per_step=32768, samples_per_ray=RECON_RCFG.num_samples_per_ray,
        runs=runs, memmap_over_ram=runs["memmap"]["ms_per_step"] / runs["ram"]["ms_per_step"],
        flash_launches=fa.LAUNCHES)
    for name, r in runs.items():
        if r["streaming"] != (name == "memmap") or r["composite_launches"] != 0 or not r["finite"]:
            raise AssertionError(f"recon-streaming: {name} {r}")
    return fa.LAUNCHES, comp.LAUNCHES


def frame_stats(records) -> dict:
    """Median and range of the per-frame ms that the camera-path render
    logged (the first frame's warm-up included)."""
    frame_ms = next(r.frame_ms for r in records if hasattr(r, "frame_ms"))
    return dict(frames=len(frame_ms), ms_per_frame_median=float(np.median(frame_ms)),
                ms_per_frame_min=min(frame_ms), ms_per_frame_max=max(frame_ms), ms_first_frame=frame_ms[0])


def check_video(path: Path, frames: int, side: int) -> None:
    num, width, height, jpegs = read_mjpeg_avi(path)
    if (num, width, height, len(jpegs)) != (frames, side, side, frames):
        raise AssertionError(f"{path}: {num} frames ({len(jpegs)} chunks) of {width}x{height}")


TURNTABLE_FRAMES = 179  # the CLI's default --num_frames 180 (the last pose dropped)


def phase_render_cli(workdir: Path, shear_warp: bool) -> tuple:
    """The render CLI on the recon CLI's model_final.pth at its full width
    (800^2, 512 samples), cut in depth to a few turntable frames; returns
    its (flash, compositing) launches."""
    name = "render-cli-shear-warp" if shear_warp else "render-cli-exact"
    num_frames = 37 if shear_warp else 9
    out = workdir / name
    args = ["-i", str(workdir / "cli_out" / "saved_models" / "model_final.pth"), "-o", str(out),
            "--num_frames", str(num_frames), "--use_shear_warp", str(shear_warp), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()  # counts from here to the end of this path's run
    frames, records = logged(render_cli.main, args)
    launches, flash = comp.LAUNCHES, fa.LAUNCHES
    stats = frame_stats(records)
    n = num_frames - 1
    log(name, **stats, turntable_179_frames_s_computed=stats["ms_per_frame_median"] * TURNTABLE_FRAMES / 1e3,
        phase_s=time.perf_counter() - t0, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        composite_launches=launches, launches_per_frame=launches / n, flash_launches=flash,
        frame_shape=list(frames.shape), video="RIFF/AVI, MJPEG")
    check_video(out / "rendered_video.mp4", n, 2 * SCENE)
    per_frame = 1 if shear_warp else -(-(2 * SCENE) ** 2 // 32768)
    if frames.shape != (n, 2 * SCENE, 2 * SCENE, 3) or stats["frames"] != n or launches != per_frame * n:
        raise AssertionError(f"{name}: frames {frames.shape}, {launches} launches, want {per_frame} a frame")
    if not 0 < frames.mean() < 255:
        raise AssertionError(f"{name}: blank frames")
    # device busy time and top kernels of one frame
    config = render_cli.build_parser().parse_args(args)
    model, info = load_volumetric_model(Path(config.model_path), device="cuda")
    model.render_config = model.render_config.replace(white_bkgd=True)
    intr, poses = render_cli.camera_setup(config, info)
    profile_call(lambda: render_camera_path_for_volumetric_model(
        model, poses[:1], intr, config.overridden_num_samples_per_ray, config.render_scale_factor,
        use_shear_warp=shear_warp), 1, stats["ms_per_frame_median"])
    return flash, launches


def phase_render_attn_cli(workdir: Path, snapshot14: Path) -> dict:
    """The attention render CLI on the refine CLI's edit attention grid at
    800^2: the blend on both routes, then live SD 1.4 attention; returns each
    run's (flash, compositing) launches."""
    model = workdir / "refine-cli" / "saved_models" / "model_final_attn_edit.pth"
    runs = {
        "render-attn-shear-warp": (5, ["--use_shear_warp", "True"], 2),
        "render-attn-exact": (3, [], -(-(2 * SCENE) ** 2 // 32768)),
        "render-attn-sd": (3, ["--use_sd", "True", "--sd_weights_dir", str(snapshot14), "--timestamp", "200",
                               "--sds_prompt", "a dog wearing a party hat", "--index_to_attn", "4"],
                           -(-(2 * SCENE) ** 2 // 32768)),
    }
    counts = {}
    for name, (num_frames, extra, per_frame) in runs.items():
        out = workdir / name
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_counts()  # counts from here to the end of this path's run
        frames, records = logged(render_attn_cli.main, [
            "-i", str(model), "-o", str(out), "--num_frames", str(num_frames), "--device", "cuda"] + extra)
        counts[name] = (fa.LAUNCHES, comp.LAUNCHES)
        n = num_frames - 1
        log(name, **frame_stats(records), phase_s=time.perf_counter() - t0,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=counts[name][0],
            composite_launches=counts[name][1], launches_per_frame=counts[name][1] / n, frame_shape=list(frames.shape))
        check_video(out / "rendered_video.mp4", n, 2 * SCENE)
        if frames.shape != (n, 2 * SCENE, 2 * SCENE, 3) or counts[name] != (0, per_frame * n):
            raise AssertionError(f"{name}: frames {frames.shape}, launches {counts[name]}, want {per_frame} a frame")
    return counts


def phase_shape_sweep(dev) -> float:
    """The compositing kernel against its plain version at every [N, S] it
    launched in this run that the kernel check did not hold; returns the
    largest error."""
    g = torch.Generator(device=dev).manual_seed(9)
    shapes = sorted(comp.LAUNCHED_SHAPES - CHECKED_SHAPES)
    errs = [hold_composite(composite_inputs(g, n, s_, 5.0, dev), f"launched_{n}x{s_}") for n, s_ in shapes]
    log("shape-sweep", launched_shapes=sorted(comp.LAUNCHED_SHAPES), swept=shapes)
    return max(errs, default=0.0)


SAFETENSORS_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16"}


def write_safetensors(tensors: dict, path: Path) -> None:
    """An 8-byte header length, the JSON header (8-byte aligned), raw bytes."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        # flat first: a channels_last [O, I, 1, 1] weight counts as contiguous
        blob = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for blob in blobs:
            f.write(blob)


def write_hf_snapshot(sd: StableDiffusion, root: Path) -> None:
    """The port's weights under their HF names (the loader's map, first
    candidate) and a byte-level BPE vocab. SD 2.x: linear proj_in /
    proj_out, padding with "!"; SD 1.x: 1x1-conv proj_in / proj_out,
    padding with the end-of-text token."""
    sd2 = sd.config.version.startswith("2")
    for name, sub in sd_weights.HF_SUBFOLDERS.items():
        module = getattr(sd, name)
        names = sd_weights.hf_names(module, sd_weights.NAME_FNS[name])
        tensors = {}
        for key, t in module.state_dict().items():
            hf = names[key][0][0]
            linear = sd2 and (".proj_in." in hf or ".proj_out." in hf) and t.dim() == 4
            tensors[hf] = t[:, :, 0, 0] if linear else t
        write_safetensors(tensors, root / sub / "model.safetensors")
    byte_tokens = list(_bytes_to_unicode().values())
    vocab = {tok: i for i, tok in enumerate(byte_tokens + [t + "</w>" for t in byte_tokens])}
    vocab.update({"<|startoftext|>": len(vocab), "<|endoftext|>": len(vocab) + 1})
    (root / "tokenizer").mkdir(parents=True)
    (root / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (root / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    pad = "!" if sd2 else "<|endoftext|>"
    (root / "tokenizer" / "special_tokens_map.json").write_text(json.dumps({"pad_token": pad}))


@torch.no_grad()
def draw_biases_(sd: StableDiffusion, seed: int) -> None:
    """Every bias of a randomly initialised SD drawn from 0.1 N(0, 1), as
    trained weights carry them (the parity tests' parameters draw them so
    too). With the init's zero biases, the validate CLI's SDS smoke feeds
    the VAE a gray image that is exactly 0 after 2x - 1, every activation
    of the encoder is 0, and each GroupNorm's backward scales by
    1/sqrt(eps) = 1e3: SD's 22 encoder norms overflow f32. The JAX tool
    does the same on the same weights (both give ~4e26 through the tiny
    VAE's 10 norms)."""
    g = torch.Generator(device=sd.device).manual_seed(seed)
    for module in (sd.clip, sd.vae, sd.unet):
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g, device=sd.device))


def phase_sd_weights(dev, workdir: Path, version: str = SD_VERSION) -> Path:
    """SD 2.0 (or 1.4) at published widths, seeded random weights with
    drawn biases, through the HF snapshot loader; returns the snapshot
    directory."""
    phase = "sd-weights" if version == SD_VERSION else "sd14-weights"
    src = StableDiffusion(version, init_mode="random", seed=5, device=dev)
    draw_biases_(src, seed=7)
    root = workdir / f"sd{version.replace('.', '')}_snapshot"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_hf_snapshot(src, root)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = StableDiffusion(version, weights_dir=root, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(6)
    ids = torch.randint(0, 514, (2, 77), generator=g, device=dev)
    img = torch.rand((1, 3, src.config.image_size, src.config.image_size), generator=g, device=dev)
    lat = torch.randn(src.latent_shape(2), generator=g, device=dev)
    before = fa.LAUNCHES
    with torch.no_grad():
        text = src.clip(ids)
        pairs = {
            "clip": (text, loaded.clip(ids)),
            "vae_encode": (src.encode_imgs(img), loaded.encode_imgs(img)),
            "unet": (src.unet_noise_pred(lat, 500, text), loaded.unet_noise_pred(lat, 500, text)),
        }
    torch.cuda.synchronize()
    equal = {k: bool(torch.equal(a, b)) for k, (a, b) in pairs.items()}
    size_gb = sum(f.stat().st_size for f in root.rglob("*.safetensors")) / 1e9
    log(phase, sd=version, snapshot_gb=size_gb, write_s=write_s, load_s=load_s, bitwise_equal=equal,
        tokenizer=type(loaded.tokenizer).__name__, pad_id=loaded.tokenizer.pad_token_id,
        unet_flash_launches=fa.LAUNCHES - before)
    if not all(equal.values()) or not isinstance(loaded.tokenizer, CLIPTokenizer):
        raise AssertionError(f"the loaded SD {version} differs from its source: {equal}")
    if version != SD_VERSION:
        attention_64(dev, loaded)
        fa.REFERENCE_ON_CUDA = 0  # the comparison above called the plain version; the breakdown must not
        refine_breakdown(dev, loaded, workdir)
    del src, loaded, pairs
    torch.cuda.empty_cache()
    return root


def attention_64(dev, sd: StableDiffusion) -> None:
    """SD 1.x's 64^2 self-attention (head_dim 40: outside the flash gate and
    the kernel): the library SDPA that the UNet calls there, against the
    plain version it called before; time and transient memory per call."""
    heads = sd.config.unet.attention_head_dim[0]
    width = sd.config.unet.block_out_channels[0]
    shape = (2, 4096, heads, width // heads)
    q, k, v = (torch.randn(shape, device=dev, dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # the UNet's call: [B, h, Q, d] views
    calls = {"sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt),
             "plain": lambda: fa.flash_attention_reference(q, k, v)}
    stats = {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        stats[f"{name}_transient_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        stats[f"{name}_ms"] = time_ms(fn, iters=10, warmup=2)
    log("attention-64", shape=list(shape), gated_to_flash=flash_self_attention_enabled(shape[1], shape[3]),
        calls_per_unet_pass=5, **stats)


def refine_breakdown(dev, sd: StableDiffusion, workdir: Path) -> None:
    """One refinement iteration at full width, layer by layer (synchronised
    host clock, median of 3 after one warm-up): the edit-cli phase's 160^3
    grid with two -20 attention channels, the 384^2 base, SD 1.4."""
    model, _ = load_volumetric_model(workdir / "edit-cli" / "saved_models" / "model_final.pth", device=dev, with_attn=True)
    grid, rcfg = model.grid, model.render_config
    attn = grid.attn.repeat(1, 1, 1, 2).requires_grad_(True)
    opt = torch.optim.Adam([attn], lr=0.028, betas=(0.9, 0.999), eps=1e-8)
    pose = pose_spherical(30.0, 40.0, 4.0311)
    rot = torch.as_tensor(pose.rotation, device=dev)
    cam = CameraPose(rot, torch.as_tensor(pose.translation, device=dev))
    text = sd.get_text_embeds("a dog wearing a party hat, side view")
    n_tok = sd.get_num_tokens("a dog wearing a party hat, side view")
    idxs, emask, omask = train_refine.token_selection(n_tok, [4, 5], None)
    gen = torch.Generator(device=dev).manual_seed(3)
    base_hw = (BASE, BASE)
    parts = {}

    def clock(name, fn):
        return clocked(parts, name, fn)

    for _ in range(4):
        with torch.no_grad():
            out = clock("rgb_frame", lambda: render_shear_warp(grid, cam, rcfg, base_hw=base_hw)[0])
        rgb = orient_base_image(out.colour.reshape(BASE, BASE, 3), rot)[None]
        lat = clock("resize_vae_encode", lambda: sd.encode_imgs(sd.resize_to_image_size(rgb), None))
        noisy = sd.scheduler.add_noise(lat, torch.randn(lat.shape, generator=gen, device=dev), 200)
        _, store = clock("capture_unet", lambda: sd.unet_noise_pred(torch.cat([noisy] * 2), 200, text, capture_attn=True))
        targets = clock("token_maps", lambda: train_refine.select_targets(
            cross_attn.aggregate_token_maps(store, idxs, BASE, BASE), emask.to(dev), omask.to(dev)))
        opt.zero_grad(set_to_none=True)
        aout = clock("attn_render_fwd", lambda: render_shear_warp(
            grid.replace(attn=attn), cam, rcfg, base_hw=base_hw, attn_mode=True, background_value=0.0)[0])
        rendered = orient_base_image(aout.colour.reshape(BASE, BASE, 2), rot)
        loss = sum(train_refine.calc_loss_on_attn_grid(rendered[..., c], targets[c]) for c in (0, 1))
        clock("attn_render_bwd", loss.backward)
        clock("adam", opt.step)
    med = {k: float(np.median(v[1:])) for k, v in parts.items()}
    log("refine-breakdown", **{f"{k}_ms": v for k, v in med.items()}, sum_ms=sum(med.values()))


def phase_refine_cli(dev, workdir: Path, snapshot14: Path) -> dict:
    """The refine CLI module end to end, then the segment CLI on its
    attention grids; returns each path's (flash, compositing) launches."""
    iters, every = 6, 3
    out = workdir / "refine-cli"
    recon = workdir / "cli_out" / "saved_models" / "model_final.pth"
    edited = workdir / "edit-cli" / "saved_models" / "model_final.pth"
    args = [
        "-d", str(workdir / "scene"), "-i", str(edited), "-r", str(recon), "-o", str(out),
        "-p", "a dog wearing a party hat", "-eidx", "4 5", "--data_downsample_factor", "1",
        "--sd_weights_dir", str(snapshot14), "--num_iterations_per_stage", str(iters),
        "--feedback_frequency", str(every), "--save_frequency", str(every), "--device", str(dev),
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()  # counts from here to the end of the refine path's run
    _, records = logged(refine_cli.main, args)
    counts = {"refine-cli": (fa.LAUNCHES, comp.LAUNCHES)}
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    done = next(r for r in records if hasattr(r, "time_training"))
    edges = next(r.graph_cut_edges for r in records if hasattr(r, "graph_cut_edges"))
    saved = out / "saved_models"
    refined, _ = load_volumetric_model(saved / "model_final_refined.pth", device=dev)
    keep = torch.unique(refined.grid.attn).tolist()
    feedback = sorted({1, iters} | set(range(every, iters + 1, every)))
    pngs = [out / "training_logs" / "rendered_output" / f"{n}_{i}.png" for i in feedback
            for n in ("edit_attn_map", "pred_attn_edit", "render_diff", "attn_attn_iter")]
    log("refine-cli", iterations=iters, ms_per_iteration=done.time_training / iters * 1e3,
        ms_per_iteration_note="time_training / iterations; the first iteration's warm-up included",
        time_training_s=done.time_training, phase_s=seconds, peak_mem_gib=peak, flash_launches=counts["refine-cli"][0],
        composite_launches=counts["refine-cli"][1], graph_cut_s=done.graph_cut_s, graph_cut_nodes=done.graph_cut_nodes,
        graph_cut_edges=edges, edit_voxels=done.edit_voxels, keep_values=keep,
        refined_loads_back=list(refined.grid.grid_dims), pngs_written=sum(p.exists() for p in pngs))
    if counts["refine-cli"] != (0, 2 * iters + 5 * len(feedback)):
        raise AssertionError(f"refine-cli: launches {counts['refine-cli']}, want (0, {2 * iters + 5 * len(feedback)})")
    if refined.grid.grid_dims != (GRID_RES,) * 3 or not set(keep) <= {-10.0, -5.0, 0.0}:
        raise AssertionError(f"refine-cli: model_final_refined.pth holds {refined.grid.grid_dims}, keep grid {keep}")
    if not torch.isfinite(refined.grid.densities).all() or not all(p.exists() for p in pngs):
        raise AssertionError("refine-cli: non-finite refined grid or feedback PNGs missing")

    seg_out = workdir / "segment-cli"
    t0 = time.perf_counter()
    reset_counts()  # counts from here to the end of the segment path's run
    segment_cli.main([
        "-d", str(workdir / "scene"), "-ie", str(saved / "model_final_attn_edit.pth"),
        "-io", str(saved / "model_final_attn_object.pth"), "-r", str(recon), "-i", str(edited),
        "-o", str(seg_out), "--data_downsample_factor", "1", "--device", str(dev),
    ])
    torch.cuda.synchronize()
    counts["segment-cli"] = (fa.LAUNCHES, comp.LAUNCHES)
    seg, _ = load_volumetric_model(seg_out / "saved_models" / "model_final_refined.pth", device=dev)
    same = bool(torch.equal(seg.grid.attn, refined.grid.attn) and torch.equal(seg.grid.densities, refined.grid.densities))
    log("segment-cli", phase_s=time.perf_counter() - t0, composite_launches=counts["segment-cli"][1],
        loads_back=list(seg.grid.grid_dims), same_merge_as_refine_cli=same)
    if not same or counts["segment-cli"][1] == 0:
        raise AssertionError(f"segment-cli: merge differs from the refine CLI's ({same}) or no launches")
    return counts


REFINE_K, REFINE_K_ITERS = 10, 20


def phase_refine_kstep(dev, workdir: Path, snapshot14: Path) -> dict:
    """The refine CLI at SD 1.4's published widths with --steps_per_call 10
    over 20 iterations (two calls; feedback on the first and the last, 5
    launches each), then the graph cut and merge; then the same at
    --steps_per_call 1 for the comparison. Returns each run's (flash,
    compositing) launches."""
    recon = workdir / "cli_out" / "saved_models" / "model_final.pth"
    edited = workdir / "edit-cli" / "saved_models" / "model_final.pth"
    counts, stats = {}, {}
    for k in (REFINE_K, 1):
        name = "refine-kstep" if k > 1 else "refine-k1"
        out = workdir / name
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # counts from here to the end of this run
        _, records = logged(refine_cli.main, [
            "-d", str(workdir / "scene"), "-i", str(edited), "-r", str(recon), "-o", str(out),
            "-p", "a dog wearing a party hat", "-eidx", "4 5", "--data_downsample_factor", "1",
            "--sd_weights_dir", str(snapshot14), "--num_iterations_per_stage", str(REFINE_K_ITERS),
            "--steps_per_call", str(k), "--device", str(dev),
        ])
        counts[name] = (fa.LAUNCHES, comp.LAUNCHES)
        done = next(r for r in records if hasattr(r, "time_training"))
        refined, _ = load_volumetric_model(out / "saved_models" / "model_final_refined.pth", device=dev)
        keep = torch.unique(refined.grid.attn).tolist()
        stats[name] = dict(ms_per_iteration=done.time_training / REFINE_K_ITERS * 1e3, graph_cut_s=done.graph_cut_s,
                           peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=counts[name][0],
                           composite_launches=counts[name][1], keep_values=keep)
        if counts[name] != (0, 2 * REFINE_K_ITERS + 5 * 2) or not set(keep) <= {-10.0, -5.0, 0.0}:
            raise AssertionError(f"{name}: launches {counts[name]}, keep grid {keep}")
    log("refine-kstep", k=REFINE_K, iterations=REFINE_K_ITERS, runs=stats,
        ms_per_iteration_note="time_training / iterations; the first call's warm-up included",
        ratio_k10_over_k1=stats["refine-kstep"]["ms_per_iteration"] / stats["refine-k1"]["ms_per_iteration"])
    return counts


def phase_edit_refine(dev, workdir: Path, snapshot: Path, snapshot14: Path) -> tuple:
    """The edit CLI with --do_refinement and --post_process_scc; returns its
    (flash, compositing) launches."""
    out = workdir / "edit-refine"
    args = [
        "-i", str(workdir / "cli_out" / "saved_models" / "model_final.pth"), "-o", str(out),
        "-p", "a dog wearing a party hat", "-d", str(workdir / "scene"), "--data_downsample_factor", "1",
        "--sd_weights_dir", str(snapshot), "--sd_version", SD_VERSION, "--sd_refine_weights_dir", str(snapshot14),
        "--num_iterations_edit", "2", "--num_iterations_refine", "2", "--fast_debug_mode", "True",
        "--do_refinement", "True", "--post_process_scc", "True", "-eidx", "4 5", "--device", str(dev),
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()  # counts from here to the end of this path's run
    edit_cli.main(args)
    torch.cuda.synchronize()
    flash, composite = fa.LAUNCHES, comp.LAUNCHES
    model, _ = load_volumetric_model(out / "saved_models" / "model_final_refined.pth", device=dev)
    log("edit-refine", sds_steps=2, refine_iterations=2, phase_s=time.perf_counter() - t0,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=flash, composite_launches=composite,
        refined_loads_back=list(model.grid.grid_dims), finite=bool(torch.isfinite(model.grid.densities).all()))
    # 5 flash launches a SDS step; compositing: 1 a SDS step, 2 a refinement
    # iteration and 5 a refinement feedback point (the refinement runs its
    # feedback: iterations 1 and 2)
    if flash != 10 or composite != 2 + 2 * 2 + 5 * 2:
        raise AssertionError(f"edit-refine: launches {flash} flash, {composite} compositing")
    if model.grid.grid_dims != (GRID_RES,) * 3 or not torch.isfinite(model.grid.densities).all():
        raise AssertionError("edit-refine: model_final_refined.pth holds no finite 160^3 grid")
    return flash, composite


def phase_edit_cli(dev, workdir: Path, snapshot: Path, data_pose: bool = False) -> tuple:
    """The edit CLI module end to end; returns its (flash, compositing)
    launches."""
    name = "edit-data-pose" if data_pose else "edit-cli"
    steps, feedback_every = (2, 3) if data_pose else (6, 3)
    out = workdir / name
    ref = workdir / "cli_out" / "saved_models" / "model_final.pth"
    args = [
        "-i", str(ref), "-o", str(out), "-p", "a dog wearing a party hat", "-d", str(workdir / "scene"),
        "--data_downsample_factor", "1", "--sd_weights_dir", str(snapshot), "--sd_version", SD_VERSION,
        "--num_iterations_edit", str(steps), "--feedback_frequency", str(feedback_every),
        "--save_frequency", str(feedback_every), "--fast_debug_mode", "False", "--device", str(dev),
    ] + (["--data_pose_mode", "True"] if data_pose else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()  # counts from here to the end of this path's run
    _, records = logged(edit_cli.main, args)
    flash, composite = fa.LAUNCHES, comp.LAUNCHES
    seconds = time.perf_counter() - t0
    time_training = next(r.time_training for r in records if hasattr(r, "time_training"))
    model, _ = load_volumetric_model(out / "saved_models" / "model_final.pth", device=dev)
    before, _ = load_volumetric_model(ref, device=dev)
    dens = model.grid.densities
    change = float((dens - before.grid.densities).abs().max())
    feedback_steps = sorted({1, steps} | set(range(feedback_every, steps + 1, feedback_every)))
    pngs = [out / "training_logs" / "rendered_output" / f"sds_{kind}iter_{i}.png"
            for i in feedback_steps for kind in ("", "diffuse_")]
    log(name, steps=steps, ms_per_step=time_training / steps * 1e3,
        ms_per_step_note="time_training / steps; the first step's warm-up included", time_training_s=time_training,
        phase_s=seconds, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=flash,
        composite_launches=composite, feedback_renders=len(pngs), grid=list(model.grid.grid_dims),
        grid_max_change=change, pngs_written=sum(p.exists() for p in pngs))
    if flash != 5 * steps:
        raise AssertionError(f"{name}: flash kernel launched {flash} times in {steps} steps, want 5 per step")
    if composite < steps + len(pngs):  # one a step, one per feedback render
        raise AssertionError(f"{name}: compositing kernel launched {composite} times")
    if model.grid.grid_dims != before.grid.grid_dims or not torch.isfinite(dens).all() or not change > 0.0:
        raise AssertionError(f"{name}: model_final.pth holds no finite, edited grid of the input's size")
    if not all(p.exists() for p in pngs):
        raise AssertionError(f"{name}: feedback PNGs missing")
    return flash, composite


SAMPLE_STEPS = 50  # the validate CLI's default --sanity_steps
FLASH_PER_UNET_PASS = 5  # SD 2.x at a 64^2 latent: down_0's 2 and up_3's 3 self-attentions pass the gate


def phase_sd_sample(dev, workdir: Path, snapshot: Path) -> tuple:
    """The validate CLI module on the SD 2.0 snapshot at its defaults (the
    SDS smoke, then text-to-image at 512^2); returns its (flash,
    compositing) launches."""
    png = workdir / "sd-sample" / "sanity.png"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()  # counts from here to the end of this path's run
    img, records = logged(validate_cli.main, [
        "-d", str(snapshot), "--sd_version", SD_VERSION, "--run_smoke", "True", "--sanity_image", str(png),
        "--device", str(dev),
    ])
    flash, composite = fa.LAUNCHES, comp.LAUNCHES
    seconds = time.perf_counter() - t0
    step_ms = next(r.ddim_step_ms for r in records if hasattr(r, "ddim_step_ms"))
    decode_ms = next(r.decode_ms for r in records if hasattr(r, "decode_ms"))
    with Image.open(png) as f:
        read = np.asarray(f)
    want = FLASH_PER_UNET_PASS * (SAMPLE_STEPS + 1)  # a CFG pass a DDIM step, one in the SDS smoke
    log("sd-sample", steps=len(step_ms), ms_per_ddim_step=float(np.median(step_ms[1:])),
        ddim_step_ms_range=[min(step_ms[1:]), max(step_ms[1:])], first_step_ms=step_ms[0],
        sampling_ms=sum(step_ms), decode_ms=decode_ms, cli_s=seconds,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=flash, want_flash_launches=want,
        png=list(read.shape), png_dtype=str(read.dtype), pixel_mean=float(read.mean()))
    if read.shape != (512, 512, 3) or read.dtype != np.uint8 or not np.array_equal(read, img):
        raise AssertionError(f"sd-sample: the PNG holds {read.shape} {read.dtype}, not the 512x512x3 uint8 image")
    if len(step_ms) != SAMPLE_STEPS or flash != want:
        raise AssertionError(f"sd-sample: {len(step_ms)} DDIM steps, {flash} flash launches (want {want})")
    return flash, composite


def phase_p2p_hook(dev, snapshot: Path) -> tuple:
    """One SD 2.0 CFG UNet pass at 512^2, plain and with an identity
    `attn_edit_fn`, then one AttentionRefine pass through the hook; returns
    the hooked passes' (flash, compositing) launches."""
    sd = StableDiffusion(SD_VERSION, weights_dir=snapshot, device=dev)
    text = sd.get_text_embeds("a dog wearing a party hat")
    g = torch.Generator(device=dev).manual_seed(8)
    lat = torch.cat([torch.randn(sd.latent_shape(1), generator=g, device=dev)] * 2)
    transformers = sum(isinstance(m, Transformer2D) for m in sd.unet.modules())
    calls = []

    def identity(probs, place, is_cross):
        calls.append((place, is_cross, tuple(probs.shape)))
        return probs

    def pass_stats(edit):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # counts from here to the end of this pass
        out = sd.unet_noise_pred(lat, 500, text, attn_edit_fn=edit)
        torch.cuda.synchronize()
        return out, (fa.LAUNCHES, comp.LAUNCHES), (torch.cuda.max_memory_allocated() - base) / 2**30

    plain, (plain_flash, _), plain_gib = pass_stats(None)
    hooked, hooked_counts, hooked_gib = pass_stats(identity)
    hooked_flash = hooked_counts[0]
    rel = float((hooked - plain).abs().max() / plain.abs().max())
    n_calls = len(calls)
    hook_ms = time_ms(lambda: sd.unet_noise_pred(lat, 500, text, attn_edit_fn=lambda p, place, c: p), 5, 1)
    plain_ms = time_ms(lambda: sd.unet_noise_pred(lat, 500, text), 5, 1)

    prompts = ["a dog wearing a party hat", "a dog wearing a red party hat"]
    ctrl = AttentionRefine(prompts, sd.tokenizer, SAMPLE_STEPS)
    pair_text = torch.cat([sd.get_text_embeds(p)[1:] for p in prompts])
    seen, finite = [], []

    def refine(probs, place, is_cross):
        out = ctrl(probs, place)
        if is_cross:
            seen.append((tuple(probs.shape), tuple(out.shape)))
        finite.append(torch.isfinite(out).all())
        return out

    reset_counts()  # counts from here to the end of this pass
    edited = sd.unet_noise_pred(lat, 500, pair_text, attn_edit_fn=refine)
    refine_flash, refine_composite = fa.LAUNCHES, comp.LAUNCHES
    ok_refine = bool(torch.stack(finite).all()) and bool(torch.isfinite(edited).all())
    log("p2p-hook", unet_pass="SD 2.0, [2, 4, 64, 64], t 500", plain_ms=plain_ms, hooked_ms=hook_ms,
        plain_transient_gib=plain_gib, hooked_transient_gib=hooked_gib, hooked_max_rel_diff=rel,
        hook_calls=n_calls, transformers=transformers, plain_flash_launches=plain_flash,
        hooked_flash_launches=hooked_flash, refine_cross_shapes=sorted({s for s, _ in seen}),
        refine_flash_launches=refine_flash, refine_finite=ok_refine)
    if plain_flash != FLASH_PER_UNET_PASS or hooked_flash != 0 or refine_flash != 0:
        raise AssertionError(f"p2p-hook: flash launches plain {plain_flash}, hooked {hooked_flash}, refine {refine_flash}")
    if n_calls != 2 * transformers or rel >= FLASH_REL_TOL:
        raise AssertionError(f"p2p-hook: {n_calls} hook calls for {transformers} transformers; max rel diff {rel}")
    if not ok_refine or len(seen) != transformers or any(a != b or a[-1] != 77 or a[0] != 2 for a, b in seen):
        raise AssertionError(f"p2p-hook: AttentionRefine shapes {seen}, finite {ok_refine}")
    del sd
    torch.cuda.empty_cache()
    return hooked_flash + refine_flash, hooked_counts[1] + refine_composite


UNET_GRAD_TOL = 5e-2  # see phase_unet_grad


def phase_unet_grad(dev, snapshot: Path) -> tuple:
    """The SD 2.0 UNet's own gradient at its published widths (random
    weights, drawn biases, bf16): latents [2, 4, 64, 64] (a 512^2 image, CFG
    batch 2), text context [2, 77, 1024], t 500, a fixed random cotangent.
    The latents and one 64^2 self-attention's to_q.weight take gradients, so
    each of the 5 flash attentions runs its backward kernels once. Held
    against the same pass with the UNet module's `flash_attention` name
    swapped for the library SDPA (forward and backward; restored in a
    finally) at UNET_GRAD_TOL of max|ref|: both sides are bf16, and their
    attention roundings differ at 5 layers forward and backward and carry
    through the rest of the UNet's backward (the forward alone reads 1.4e-2
    bf16 flash against f32 probs, PERF.md §6). Returns the forward and
    backward flash launches of one pass."""
    sd = StableDiffusion(SD_VERSION, weights_dir=snapshot, device=dev)
    text = sd.get_text_embeds("a dog wearing a party hat").to(sd.unet_dtype)
    g = torch.Generator(device=dev).manual_seed(9)
    lat = torch.randn((2, 4, 64, 64), generator=g, device=dev).to(sd.unet_dtype)
    lat = lat.contiguous(memory_format=torch.channels_last)
    cot = torch.randn((2, 4, 64, 64), generator=g, device=dev)
    to_q = sd.unet.down_0_attn_0.transformer_blocks_0.attn1.to_q
    to_q.weight.requires_grad_(True)

    def grads():
        to_q.weight.grad = None
        x = lat.detach().clone().requires_grad_(True)
        (sd.unet(x, 500, text).float() * cot).sum().backward()
        return x.grad.float(), to_q.weight.grad.float()

    try:
        grads()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()  # counts from here to the end of this pass
        flash_grads = grads()
        torch.cuda.synchronize()
        flash, bwd, plain = fa.LAUNCHES, fa.LAUNCHES_BWD, fa.REFERENCE_ON_CUDA
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        peak_total = torch.cuda.max_memory_allocated() / 2**30
        pass_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            grads()
            torch.cuda.synchronize()
            pass_ms.append((time.perf_counter() - t0) * 1e3)
        swapped = sd_unet.flash_attention

        def sdpa(q, k, v, scale):
            return F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)), scale=scale).transpose(1, 2)

        sd_unet.flash_attention = sdpa
        try:
            sdpa_grads = grads()
            torch.cuda.synchronize()
            sdpa_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                grads()
                torch.cuda.synchronize()
                sdpa_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            sd_unet.flash_attention = swapped
    finally:
        to_q.weight.requires_grad_(False)
        to_q.weight.grad = None
    rel = {n: float((a - b).abs().max() / b.abs().max()) for n, a, b in zip(("latents", "to_q_weight"), flash_grads,
                                                                             sdpa_grads)}
    finite = all(bool(torch.isfinite(x).all()) for x in flash_grads)
    log("unet-grad", unet="SD 2.0, [2, 4, 64, 64], context [2, 77, 1024], t 500, bf16",
        fwd_bwd_ms=float(np.median(pass_ms)), fwd_bwd_ms_range=[min(pass_ms), max(pass_ms)],
        sdpa_route_fwd_bwd_ms=float(np.median(sdpa_ms)), transient_gib=peak, peak_mem_gib=peak_total,
        flash_launches=flash, flash_bwd_launches=bwd, plain_attention_calls=plain, rel_err_vs_sdpa=rel,
        rel_tol=UNET_GRAD_TOL, finite=finite, grad_max=[float(x.abs().max()) for x in flash_grads])
    if flash != FLASH_PER_UNET_PASS or bwd != FLASH_PER_UNET_PASS or plain != 0:
        raise AssertionError(f"unet-grad: {flash} forward and {bwd} backward flash launches, {plain} plain calls")
    if not finite or not max(rel.values()) < UNET_GRAD_TOL:
        raise AssertionError(f"unet-grad: flash-route gradients against SDPA's {rel}, finite {finite}")
    del sd
    torch.cuda.empty_cache()
    return flash, bwd


FEATURES = 12  # DVGO's rgbnet_dim: the feature channels the grid stores
FEATURE_LR_GRID, FEATURE_LR_HEADS = 0.03, 1e-3  # the recon CLI's grid lr; DVGO's rgbnet lr
FEATURE_STEPS = 8


def phase_feature_grid(dev, workdir: Path) -> tuple:
    """The feature-voxel model at the recon path's size: a 160^3 grid of 12
    features with the reference's 64-wide, 4-deep rgbnet (about 0.2 GB of
    grid). A 400^2 image of the synthetic scene at 512 samples in the exact
    renderer's 32,768-ray chunks; then training steps at the recon CLI's ray
    batch (32,768 rays x 256 samples, jittered): L1 against the scene's
    pixels, Adam on the grid and the heads. Returns its (flash, compositing)
    launches (compositing 0: the feature render composites in plain PyTorch,
    as in JAX)."""
    scene = workdir / "scene"
    train = PosedImagesDataset(scene / "train", scene / "train_camera_params.json", rgba_white_bkgd=True, device=dev)
    images, poses = train.device_arrays()
    rg = make_recon_grid(GRID_RES, dev)
    cfg = fvg.FeatureVoxelGridConfig(
        voxel_size=rg.config.voxel_size, density_preactivation="identity", density_postactivation="softplus",
        expected_density_scale=rg.config.expected_density_scale,
    )
    g = torch.Generator(device=dev).manual_seed(12)
    grid = fvg.create_feature_voxel_grid(g, (GRID_RES,) * 3, FEATURES, cfg)
    grid = grid.replace(densities=grid.densities * 2 - 1)  # the recon grid's uniform(-1, 1) raw density
    grid_gb = (grid.densities.numel() + grid.features.numel()) * 4 / 1e9
    intr = train.camera_intrinsics
    rcfg = SHVoxGridRenderConfig(num_samples_per_ray=512, camera_bounds=train.camera_bounds, white_bkgd=True)
    pose = poses[0]
    rays = flatten_rays(cast_rays(intr, pose[:, :3], pose[:, 3:]))
    chunk = rcfg.parallel_rays_chunk_size

    @torch.no_grad()
    def image():
        parts = [render_feature_voxel_grid(grid, Rays(rays.origins[i:i + chunk], rays.directions[i:i + chunk]),
                                           rcfg).colour for i in range(0, rays.origins.shape[0], chunk)]
        return torch.cat(parts).reshape(intr.height, intr.width, 3)

    reset_counts()  # counts from here to the end of this path's run
    image()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = image()
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
    render_peak = torch.cuda.max_memory_allocated() / 2**30

    params = grid.parameters()
    for t in params:
        t.requires_grad_(True)
    opt = torch.optim.Adam([{"params": params[:2], "lr": FEATURE_LR_GRID},
                            {"params": params[2:], "lr": FEATURE_LR_HEADS}], betas=(0.9, 0.999), eps=1e-8)
    tcfg = rcfg.replace(num_samples_per_ray=256)
    n_pix = intr.height * intr.width
    head0 = grid.rgbnet[0][0].detach().clone()

    def step():
        flat = torch.randint(0, images.shape[0] * n_pix, (32768,), generator=g, device=dev)
        target = images.reshape(-1, images.shape[-1])[flat][..., :3]
        out = render_feature_voxel_grid(grid, train_recon.cast_rays_at_indices(intr, poses, flat), tcfg, generator=g)
        loss = (out.colour - target).abs().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [float(step())]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(FEATURE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    composite, flash = comp.LAUNCHES, fa.LAUNCHES
    moved = float((grid.rgbnet[0][0].detach() - head0).abs().max())
    log("feature-grid", grid=GRID_RES, features=FEATURES, rgbnet=f"{cfg.rgbnet_width}x{cfg.rgbnet_depth}",
        grid_gb=grid_gb, image=f"{intr.height}x{intr.width}", samples=512, chunk=chunk,
        ms_per_image=float(np.median(render_ms)), ms_per_image_range=[min(render_ms), max(render_ms)],
        render_peak_mem_gib=render_peak, rays_per_step=32768, train_samples=256,
        ms_per_step=float(np.median(step_ms)), ms_per_step_range=[min(step_ms), max(step_ms)],
        train_peak_mem_gib=train_peak, losses=losses, rgbnet_moved=moved, composite_launches=composite,
        flash_launches=flash, image_mean=float(img.mean()))
    if not (torch.isfinite(img).all() and all(np.isfinite(losses)) and moved > 0.0):
        raise AssertionError(f"feature-grid: image finite {bool(torch.isfinite(img).all())}, losses {losses}")
    del grid, opt
    torch.cuda.empty_cache()
    return flash, composite


GRID_REFINE_ITERS = 4


def phase_grid_refine(dev, workdir: Path, snapshot14: Path) -> tuple:
    """The legacy grid_refine loop on the 160^3 grids the CLI phases wrote
    (the recon CLI's model_final.pth as the reference, the edit CLI's as the
    SDS model, the refine CLI's attention grids), 384^2 base, SD 1.4 from
    the snapshot: 4 iterations with the attention re-learn, a graph cut and
    merge at iterations 1 and 4, feedback renders. Returns its (flash,
    compositing) launches."""
    saved = workdir / "refine-cli" / "saved_models"
    models = {role: load_volumetric_model(path, device=dev)[0] for role, path in (
        ("sds", workdir / "edit-cli" / "saved_models" / "model_final.pth"),
        ("edit", saved / "model_final_attn_edit.pth"), ("object", saved / "model_final_attn_object.pth"),
        ("ref", workdir / "cli_out" / "saved_models" / "model_final.pth"))}
    train = PosedImagesDataset(workdir / "scene" / "train", workdir / "scene" / "train_camera_params.json",
                               rgba_white_bkgd=True, device=dev)
    sd = StableDiffusion("1.4", weights_dir=snapshot14, device=dev)
    out = workdir / "grid-refine"
    attn_before = models["edit"].grid.attn.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()  # counts from here to the end of this path's run
    _, records = logged(
        grid_refine.refine_model, models["sds"], models["edit"], models["object"], models["ref"], train, out,
        "a dog wearing a party hat", 4, 5, 0,
        num_iterations_per_stage=GRID_REFINE_ITERS, refine_freq=GRID_REFINE_ITERS, relearn_attn_grids=True,
        sd_model=sd, shear_warp_base_res=BASE, device=dev,
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    composite, flash = comp.LAUNCHES, fa.LAUNCHES
    done = next(r for r in records if hasattr(r, "num_cuts"))
    files = sorted(p.name for p in (out / "saved_models").iterdir())
    pngs = sorted(p.name for p in (out / "training_logs" / "rendered_output").glob("*.png"))
    final, _ = load_volumetric_model(out / "saved_models" / "model_final_sds.pth", device=dev)
    keep = torch.unique(final.grid.attn).tolist()
    moved = float((models["edit"].grid.attn - attn_before).abs().max())
    feedback = 2  # iteration 1 and the last
    # 2 a re-learn iteration (RGB frame, two-channel attention render); 1 a
    # cut's feedback render; 2 an attention feedback point (colour, attention)
    want = 2 * GRID_REFINE_ITERS + done.num_cuts + 2 * feedback
    log("grid-refine", iterations=GRID_REFINE_ITERS, base=BASE,
        ms_per_iteration=done.relearn_s / GRID_REFINE_ITERS * 1e3,
        ms_per_iteration_note="the re-learn steps (RGB frame, SD 1.4 capture, dual update), first included",
        time_training_s=done.time_training, graph_cut_s=done.graph_cut_s, num_cuts=done.num_cuts, phase_s=seconds,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, composite_launches=composite,
        want_composite_launches=want, flash_launches=flash, files=files, pngs=pngs, keep_values=keep,
        edit_attn_moved=moved)
    names = {f"model_{n}_stage_1_iter_{i}.pth" for n in ("edit", "pbject") for i in (1, GRID_REFINE_ITERS)}
    names |= {f"model_final_{n}.pth" for n in ("edit", "object", "sds")}
    if done.num_cuts != 2 or composite != want or flash != 0 or set(files) != names:
        raise AssertionError(f"grid-refine: {done.num_cuts} cuts, launches {composite} (want {want}), "
                             f"flash {flash}, files {files}")
    if final.grid.grid_dims != (GRID_RES,) * 3 or not set(keep) <= {-10.0, -5.0, 0.0} or not moved > 0.0:
        raise AssertionError(f"grid-refine: final SDS grid {final.grid.grid_dims}, keep {keep}, moved {moved}")
    del sd, models
    torch.cuda.empty_cache()
    return flash, composite

PAR_RECON_K, PAR_SDS_K, PAR_ROUNDS = 10, 3, 2
PAR_RECON_TOL = 1e-6  # of max|grid|: at world size 1 the sharded step is the unsharded one (bitwise expected)
PAR_SDS_TOL = 1e-3  # of max|grid|: the edit step's card tolerance (small-check)


def nccl_device_ms(fn, steps: int) -> dict:
    """Device ms a step of each NCCL kernel in one call of fn (`steps`
    steps), from torch.profiler: {kernel: [ms a step, launches a step]}
    (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not any(e.self_device_time_total > 0 for e in events):
        return None
    return {e.key[:60]: [e.self_device_time_total / 1e3 / steps, e.count / steps]
            for e in events if "nccl" in e.key.lower()}


def sharded_pair(build, call, rounds: int, k: int) -> dict:
    """The sharded and the unsharded call of a K-step builder from equal
    states, in turns (sharded, unsharded) for `rounds` rounds: ms per step
    of each (median over the rounds), and the grids after the last."""
    states = {name: build(name == "sharded") for name in ("sharded", "unsharded")}
    ms = {name: [] for name in states}
    for _ in range(rounds):
        for name, state in states.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = call(state)
            float(m["total_loss"])  # the summary's read
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / k)
    return dict(states=states, ms={name: float(np.median(v)) for name, v in ms.items()},
                ms_rounds=ms)


def grid_gap(states) -> tuple:
    """(max|sharded - unsharded| over both grid tensors, max|unsharded|, bitwise)."""
    a, b = states["sharded"]["grid"], states["unsharded"]["grid"]
    gap = max(float((getattr(a, n) - getattr(b, n)).abs().max()) for n in ("densities", "features"))
    scale = max(float(getattr(b, n).abs().max()) for n in ("densities", "features"))
    same = all(torch.equal(getattr(a, n), getattr(b, n)) for n in ("densities", "features"))
    return gap, scale, same


def phase_parallel_nccl(dev, workdir: Path) -> tuple:
    """The data-parallel paths at world size 1 on NCCL (one card: NCCL
    refuses two ranks on one device): the group from torchrun's variables
    through maybe_init_distributed, the mesh passed to the step builders, so
    the row split, the gather and the gradient all-reduce run. The recon
    K-step at full width (160^3, 768^2 base, the fused compositing kernel)
    and the SDS edit K-step (SD 2.0 widths, 160^3, 384^2 base) each against
    the same call without a mesh from the same state; then the recon CLI
    with --multihost True. Returns its (flash, compositing) launches."""
    import torch.distributed as dist

    from voxe_tpu_torch.parallel.distributed import free_port, maybe_init_distributed
    from voxe_tpu_torch.parallel.mesh import make_mesh

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    os.environ.update(env)
    try:
        if not maybe_init_distributed(True, device="cuda", timeout_s=120.0) or dist.get_backend() != "nccl":
            raise AssertionError("parallel-nccl: no NCCL process group")
        mesh = make_mesh(1)
        warm = torch.ones(1, device=dev)
        dist.all_reduce(warm)  # creates the NCCL communicator outside the timed calls
        if float(warm) != 1.0:
            raise AssertionError(f"parallel-nccl: all-reduce at world size 1 gave {float(warm)}")

        scene = workdir / "scene"
        train = PosedImagesDataset(scene / "train", scene / "train_camera_params.json", rgba_white_bkgd=True,
                                   device=dev)
        images, poses = train.device_arrays()
        base_hw = (RECON_BASE, RECON_BASE)
        targets, masks = train_recon.warp_dataset_to_base(images, poses, train.camera_intrinsics,
                                                          make_recon_grid(GRID_RES, dev), base_hw)
        rcfg = RECON_RCFG.replace(camera_bounds=train.camera_bounds)
        idxs = np.random.default_rng(11).integers(0, len(train), PAR_RECON_K)

        def recon_state(sharded):
            grid = make_recon_grid(GRID_RES, dev)
            opt = train_sds.make_adam(grid, 0.03)
            multi = train_recon.make_recon_train_multi_step_shearwarp(
                rcfg, opt, base_hw, PAR_RECON_K, True, lr_schedule=train_recon.exponential_decay_staircase(
                    0.03, 400, 0.1), mesh=mesh if sharded else None)
            return dict(grid=grid, multi=multi)

        def recon_call(state):
            return state["multi"](state["grid"], targets, masks, poses, idxs)

        sd = StableDiffusion(SD_VERSION, init_mode="random", seed=0, device=dev)
        text_by_dir = torch.stack([sd.get_text_embeds(f"a dog made of yarn, {d} view") for d in DIRECTION_PROMPTS])
        t_bounds = torch.tensor([[500, 500]] * PAR_SDS_K)

        def sds_state(sharded):
            grid = make_grid(GRID_RES, dev)
            opt = train_sds.make_adam(grid, 0.03)
            multi = train_sds.make_sds_train_multi_step(
                sd, RCFG, opt, CameraIntrinsics(BASE, BASE, float(BASE)), PAR_SDS_K,
                density_correlation_weight=200.0, guidance_scale=100.0, use_shear_warp=True,
                sw_base_hw=(BASE, BASE), mesh=mesh if sharded else None)
            return dict(grid=grid, ref=(grid.densities.detach().clone(), grid.features.detach().clone()),
                        multi=multi, gen=torch.Generator(device=dev).manual_seed(1))

        def sds_call(state):
            return state["multi"](state["grid"], text_by_dir, *state["ref"], t_bounds, state["gen"])

        torch.cuda.synchronize()
        reset_counts()  # counts from here to the end of this path's run
        calls0 = dict(mesh.calls)
        recon = sharded_pair(recon_state, recon_call, PAR_ROUNDS, PAR_RECON_K)
        recon_calls = {k: v - calls0.get(k, 0) for k, v in mesh.calls.items()}
        recon_launches = comp.LAUNCHES
        gap, scale, same = grid_gap(recon["states"])
        nccl = nccl_device_ms(lambda: recon_call(recon["states"]["sharded"]), PAR_RECON_K)
        log("parallel-nccl-recon", world=1, backend=dist.get_backend(), grid=GRID_RES, base=RECON_BASE,
            k=PAR_RECON_K, rounds=PAR_ROUNDS, ms_per_step_sharded=recon["ms"]["sharded"],
            ms_per_step_unsharded=recon["ms"]["unsharded"], ms_rounds=recon["ms_rounds"],
            nccl_kernels_ms_and_launches_per_step=json.dumps(nccl).replace(" ", ""), collectives=recon_calls,
            composite_launches=recon_launches, max_grid_diff=gap, max_grid=scale, bitwise=same,
            tol_rel=PAR_RECON_TOL, card=card_line().replace(" ", "_"))
        want = 2 * PAR_RECON_K * PAR_ROUNDS * 2
        if not (gap <= PAR_RECON_TOL * scale and recon_launches == want):
            raise AssertionError(f"parallel-nccl recon: grid gap {gap} of {scale}, {recon_launches} launches")
        if recon_calls.get("all_reduce_grads") != PAR_RECON_K * PAR_ROUNDS:
            raise AssertionError(f"parallel-nccl recon: collectives {recon_calls}")

        flash0 = fa.LAUNCHES
        sds = sharded_pair(sds_state, sds_call, PAR_ROUNDS, PAR_SDS_K)
        sds_flash = fa.LAUNCHES - flash0
        gap, scale, same = grid_gap(sds["states"])
        sds_nccl = nccl_device_ms(lambda: sds_call(sds["states"]["sharded"]), PAR_SDS_K)
        log("parallel-nccl-sds", world=1, sd=SD_VERSION, grid=GRID_RES, base=BASE, k=PAR_SDS_K, rounds=PAR_ROUNDS,
            ms_per_step_sharded=sds["ms"]["sharded"], ms_per_step_unsharded=sds["ms"]["unsharded"],
            ms_rounds=sds["ms_rounds"], nccl_kernels_ms_and_launches_per_step=json.dumps(sds_nccl).replace(" ", ""),
            flash_launches=sds_flash,
            max_grid_diff=gap, max_grid=scale, bitwise=same, tol_rel=PAR_SDS_TOL,
            card=card_line().replace(" ", "_"))
        want = FLASH_PER_UNET_PASS * PAR_SDS_K * PAR_ROUNDS * 2
        if not (gap <= PAR_SDS_TOL * scale and sds_flash == want):
            raise AssertionError(f"parallel-nccl sds: grid gap {gap} of {scale}, {sds_flash} flash launches")
        flash, composite = fa.LAUNCHES, comp.LAUNCHES
        del sd, sds, recon
        torch.cuda.empty_cache()

        out = workdir / "cli_multihost"
        t0 = time.perf_counter()
        logged(recon_cli.main, ["-d", str(scene), "-o", str(out), "--num_stages", "1", "--num_iterations_per_stage",
                                "3", "--use_fused_kernel", "True", "--device", "cuda", "--multihost", "True",
                                "--num_devices", "1"])
        cli_s = time.perf_counter() - t0
        model, _ = load_volumetric_model(out / "saved_models" / "model_final.pth", device="cuda")
        files = sorted(p.name for p in (out / "saved_models").iterdir())
        log("parallel-nccl-cli", multihost=True, num_devices=1, seconds=cli_s, saved_models=files,
            camera_rays_png=(out / "camera_rays.png").exists(), final_grid=list(model.grid.grid_dims),
            composite_launches=comp.LAUNCHES - composite)
        if model.grid.grid_dims != (GRID_RES,) * 3 or not torch.isfinite(model.grid.densities).all() or not (
                out / "camera_rays.png").exists():
            raise AssertionError(f"parallel-nccl: the recon CLI with --multihost wrote {files}")
        return fa.LAUNCHES, comp.LAUNCHES
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


EVAL_SIDE, EVAL_FRAMES, EVAL_PROMPTS = SCENE, 4, ("golden_dog", "blue_dog")
# FID on the card (TF32 off) against --device cpu, relative: 4.7e-6 read on
# "NVIDIA H100 80GB HBM3, 700.00 W" (4 frames a folder: rank-3 covariances,
# whose sqrtm amplifies the features' f32 differences); held at 1e-4
EVAL_FID_REL_TOL = 1e-4
EVAL_CLIP_TOL = 1e-5  # CLIP columns card against cpu, absolute (cosine similarities)



MESH_ROUTE_RANKS, MESH_ROUTE_ITERS = 2, 5
MESH_ROUTE_TOL = 1e-5  # of max|grad|: one f32 contraction, the card's (no TF32) against the CPU's


def phase_bf16_mesh_route(dev) -> None:
    """The bf16 table's mesh route, which one card never takes (world size
    1 keeps the one cast): the table stays f32 (`_table`) and each rank's
    row resample casts it (`_BF16RowResample`), whose backward contracts the
    rank's rows in f32. (1) `_resample_rows` at the recon render's shapes
    (one rank's 384 of the 768 base rows, 160 slices of a 160^3 grid of 4
    channels, hat weights of two taps a row) on the card against the same
    product in f32 on the CPU: the bf16 forward within one bf16 ulp (two
    taps sum exactly in f32, so only the rounding differs), the f32
    gradient at MESH_ROUTE_TOL of max.
    (2) A weighted sum of the recon render (160^3, 768^2 base, the fused
    compositing kernel), forward and backward: MESH_ROUTE_RANKS ranks'
    shares in turn on the card (Mesh records without a group: the render
    issues no collective, and autograd sums the shares in f32 as the
    all-reduce does) against the one-cast route without a mesh: ms and peak
    memory of each, each gradient's distance from the f32-table gradient,
    and the mesh route's gradient held at MESH_ROUTE_TOL of max against the
    one-process gradient with every row through `_BF16RowResample` (the
    unrounded sum: `_table` swapped for the identity, restored after)."""
    from voxe_tpu_torch.parallel.mesh import Mesh, shard_axis
    from voxe_tpu_torch.render import shearwarp as sw

    half = RECON_BASE // MESH_ROUTE_RANKS
    g = torch.Generator().manual_seed(21)
    src = torch.rand((GRID_RES, half), generator=g) * GRID_RES - 0.5  # a slice's source rows, as the render's
    wa = sw._interp_matrices(src, GRID_RES).to(torch.bfloat16)  # hat weights: two taps a row
    table = torch.rand((GRID_RES, GRID_RES, GRID_RES * 4), generator=g) * 2 - 1
    cot = torch.randn((GRID_RES, half, GRID_RES * 4), generator=g).to(torch.bfloat16)
    x = table.to(dev).requires_grad_(True)
    out = sw._resample_rows(wa.to(dev), x)
    out.backward(cot.to(dev))
    want = torch.bmm(wa.float(), table.to(torch.bfloat16).float())
    want_grad = torch.bmm(wa.float().transpose(1, 2), cot.float())
    fwd_ok = out.dtype == torch.bfloat16 and within_bf16_ulp(out.cpu(), want, 0.0)
    grad_err = float((x.grad.cpu() - want_grad).abs().max() / want_grad.abs().max())

    grid = make_recon_grid(GRID_RES, dev)
    pose, base_hw = pose_spherical(30.0, 40.0, 4.0), (RECON_BASE, RECON_BASE)
    weights = torch.randn((RECON_BASE, RECON_BASE, 3), generator=torch.Generator(device=dev).manual_seed(3),
                          device=dev)
    meshes = [Mesh(group=None, rank=r, size=MESH_ROUTE_RANKS, device=dev) for r in range(MESH_ROUTE_RANKS)]

    def grad(gather_dtype, sharded):
        d, f = grid.densities.clone().requires_grad_(True), grid.features.clone().requires_grad_(True)
        gr = grid.replace(densities=d, features=f, config=dataclasses.replace(grid.config, gather_dtype=gather_dtype))
        for mesh in meshes if sharded else [None]:
            colour = render_shear_warp(gr, pose, RECON_RCFG, base_hw, mesh=mesh)[0].colour
            w = weights if mesh is None else shard_axis(mesh, weights, 0)
            (colour * w.reshape(-1, 3)).sum().backward()
        return torch.cat([d.grad.reshape(-1), f.grad.reshape(-1)])

    def dist(a, b):
        return float((a - b).abs().max() / b.abs().max())

    f32_table = grad("float32", False)
    table_fn = sw._table
    sw._table = lambda unified, gather_dtype, mesh: unified  # one process, every row through _BF16RowResample
    try:
        unrounded = grad("bfloat16", False)
    finally:
        sw._table = table_fn
    routes = {}
    for name, sharded in (("mesh_route", True), ("one_cast", False), ("mesh_route_again", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = grad("bfloat16", sharded)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = time_ms(lambda: grad("bfloat16", sharded), iters=MESH_ROUTE_ITERS, warmup=1)
        routes[name] = dict(ms_fwd_bwd=ms, transient_gib=peak, finite=bool(torch.isfinite(got).all()),
                            dist_to_f32_table=dist(got, f32_table), dist_to_unrounded=dist(got, unrounded))
    log("bf16-mesh-route", ranks=MESH_ROUTE_RANKS, grid=GRID_RES, base=RECON_BASE,
        resample_shape=[list(wa.shape), list(table.shape)], resample_fwd_within_bf16_ulp=fwd_ok,
        resample_grad_rel_err=grad_err, tol=MESH_ROUTE_TOL, unrounded_dist_to_f32_table=dist(unrounded, f32_table),
        routes=json.dumps(routes).replace(" ", ""), card=card_line().replace(" ", "_"))
    if not (fwd_ok and x.grad.dtype == torch.float32 and grad_err <= MESH_ROUTE_TOL):
        raise AssertionError(f"bf16-mesh-route: resample forward {fwd_ok}, gradient {x.grad.dtype} {grad_err}")
    if not (all(r["finite"] for r in routes.values()) and routes["mesh_route"]["dist_to_unrounded"]
            <= MESH_ROUTE_TOL):
        raise AssertionError(f"bf16-mesh-route: {routes}")

def _logit(rgb) -> torch.Tensor:
    p = torch.tensor(rgb, dtype=torch.float32)
    return torch.log(p / (1.0 - p))


def write_eval_tree(root: Path, dev) -> int:
    """One scene of the evaluation CLI's layout: inputs/ (the 160^3 demo
    grid), recon/ (its features perturbed, the reference's "color_" file
    prefix), two prompt folders (recoloured grids), EVAL_FRAMES 400^2 exact
    frames each through the compositing kernel, and the prompt.txt files.
    Returns the compositing launches."""
    from voxe_tpu_torch.tools.oracle import demo_render_config

    grid = make_demo_grid(GRID_RES, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    dense = (grid.densities > 0.0).float()
    grids = {
        "inputs": (grid, ""),
        "recon": (grid.replace(features=grid.features + 0.3 * torch.randn(grid.features.shape, generator=g,
                                                                            device=dev)), "a render of a dog"),
        EVAL_PROMPTS[0]: (grid.replace(features=grid.features * (1 - dense) + dense * _logit((0.95, 0.75, 0.1)).to(
            dev)), "a render of a golden dog"),
        EVAL_PROMPTS[1]: (grid.replace(features=grid.features * (1 - dense) + dense * _logit((0.1, 0.2, 0.9)).to(
            dev)), "a render of a blue dog"),
    }
    rcfg, intr = demo_render_config(), CameraIntrinsics(EVAL_SIDE, EVAL_SIDE, float(EVAL_SIDE))
    launches = comp.LAUNCHES
    for folder, (gr, prompt) in grids.items():
        d = root / folder
        d.mkdir(parents=True)
        prefix = "color_" if folder == "recon" else ""
        for i, yaw in enumerate(np.linspace(0.0, 360.0, EVAL_FRAMES + 1)[:-1]):
            Image.fromarray(render_frame(gr, rcfg, intr, float(yaw))[0]).save(d / f"{prefix}frame_{i}.png")
        if prompt:
            (d / "prompt.txt").write_text(prompt + "\n")
    torch.cuda.synchronize()
    return comp.LAUNCHES - launches


def write_tiny_clip(root: Path) -> Path:
    """A tiny random-weight transformers CLIP snapshot (model, processor and
    a byte-level BPE vocab), as tests/test_evaluation.py builds it."""
    from transformers import (CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPProcessor, CLIPTextConfig,
                              CLIPTokenizer, CLIPVisionConfig)

    root.mkdir(parents=True, exist_ok=True)
    text_cfg = CLIPTextConfig(vocab_size=514, hidden_size=32, intermediate_size=37, num_hidden_layers=2,
                              num_attention_heads=4, max_position_embeddings=77)
    vision_cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=37, num_hidden_layers=2, num_attention_heads=4,
                                  image_size=224, patch_size=32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        CLIPModel(CLIPConfig(text_config=text_cfg.to_dict(), vision_config=vision_cfg.to_dict(),
                             projection_dim=16)).save_pretrained(root)
    byte_tokens = list(_bytes_to_unicode().values())
    vocab = {tok: i for i, tok in enumerate(byte_tokens + [t + "</w>" for t in byte_tokens])}
    vocab.update({"<|startoftext|>": len(vocab), "<|endoftext|>": len(vocab) + 1})
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n")
    CLIPProcessor(CLIPImageProcessor(), CLIPTokenizer(str(root / "vocab.json"), str(root / "merges.txt"))
                  ).save_pretrained(root)
    return root


def _importable(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def phase_eval_cli(dev, workdir: Path) -> tuple:
    """The evaluation CLI on a result tree of 400^2 frames: a random-weight
    full-width Inception3 (1000 classes, 2048-d pool3) and, where
    transformers imports, a tiny random CLIP; the CLI on the card, then with
    --device cpu on a copy of the tree. PSNR equal as text, FID within
    EVAL_FID_REL_TOL relative, CLIP within EVAL_CLIP_TOL, the same CSV
    layout; the Inception embedder's images a second on the card. Returns
    the (flash, compositing) launches of the tree's frames and the card's
    CLI run."""
    import shutil

    from voxe_tpu_torch.evaluation.inception import Inception3
    from voxe_tpu_torch.evaluation.metrics_lib import InceptionEmbedder, get_images

    root = workdir / "eval"
    reset_counts()  # counts from here to the end of the card's CLI run
    launches = write_eval_tree(root / "results_card" / "dog2", dev)
    shutil.copytree(root / "results_card", root / "results_cpu")
    inception = root / "inception"
    inception.mkdir()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = Inception3(num_classes=1000)
        for m in model.modules():  # He init: torch's default lets the activations vanish over 94 convs
            if isinstance(m, torch.nn.Conv2d):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
        torch.save(model.state_dict(), inception / "inception_v3.pth")
    has_transformers, has_pandas = _importable("transformers"), _importable("pandas")
    flags = ["--inception_model_dir", str(inception)]
    if has_transformers:
        flags += ["--clip_model_dir", str(write_tiny_clip(root / "clip"))]
    # the --device cpu run in a process of its own beside the card's: both
    # spend most of their time in scipy's sqrtm on the host
    t0 = time.perf_counter()
    with open(root / "cpu_run.log", "w") as cpu_log:
        cpu_run = subprocess.Popen([sys.executable, "-m", "voxe_tpu_torch.cli.calculate_metrics", "-d",
                                    str(root / "results_cpu"), *flags, "--device", "cpu"], stdout=cpu_log,
                                   stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent)
    try:
        logged(calc_metrics_cli.main, ["-d", str(root / "results_card"), *flags, "--device", str(dev)])
        seconds = {"card": time.perf_counter() - t0}
        counts = fa.LAUNCHES, comp.LAUNCHES
        code = cpu_run.wait(timeout=600)
    finally:
        if cpu_run.poll() is None:
            cpu_run.kill()
            cpu_run.wait()
    seconds["cpu"] = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"eval-cli: the --device cpu run exited {code}: {(root / 'cpu_run.log').read_text()[-2000:]}")
    csvs = {d: (root / f"results_{d}" / "output_metrics.csv").read_text().splitlines() for d in ("card", "cpu")}
    card, host = ([line.split(",") for line in csvs[d]] for d in ("card", "cpu"))
    same_layout = len(card) == len(host) and all(len(a) == len(b) and a[0] == b[0] for a, b in zip(card, host)) \
        and card[:2] == host[:2]
    gaps = {}
    for a, b in zip(card[2:], host[2:]):
        if len(a) != 6:
            continue
        for col, x, y in zip(calc_metrics_cli.COLUMNS, a[1:], b[1:]):
            if col == "PSNR recon":
                gaps.setdefault(col, []).append(x == y)
            elif x and y:
                gap = abs(float(x) - float(y)) / (abs(float(y)) if col.startswith("FID") else 1.0)
                gaps.setdefault(col, []).append(gap)
    imgs = get_images(root / "results_card" / "dog2" / EVAL_PROMPTS[0]) * 8
    embedder = InceptionEmbedder(inception, device=dev)
    embedder.features(imgs[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embedder.features(imgs)
    torch.cuda.synchronize()
    per_s = len(imgs) / (time.perf_counter() - t0)
    fid_gap = max(gaps.get("FID recon", [np.inf]) + gaps.get("FID input", [np.inf]))
    clip_gap = max(gaps.get("text CLIP", [0.0]) + gaps.get("dir CLIP", [0.0]))
    log("eval-cli", transformers=has_transformers, pandas=has_pandas, frames_per_folder=EVAL_FRAMES,
        side=EVAL_SIDE, prompts=len(EVAL_PROMPTS), csv_lines=len(card), same_layout=same_layout,
        psnr_equal=all(gaps.get("PSNR recon", [False])), fid_rel_gap=fid_gap, fid_rel_tol=EVAL_FID_REL_TOL,
        clip_abs_gap=clip_gap, clip_tol=EVAL_CLIP_TOL, cli_s_card=seconds["card"], cli_s_cpu_beside_it=seconds["cpu"],
        inception_images_per_s=per_s, composite_launches=counts[1], flash_launches=counts[0],
        card=card_line().replace(" ", "_"))
    print("[eval-cli-csv] " + json.dumps(csvs), flush=True)
    if not (same_layout and len(gaps.get("PSNR recon", [])) == len(EVAL_PROMPTS) and all(gaps["PSNR recon"])):
        raise AssertionError(f"eval-cli: card and CPU CSVs differ in layout or PSNR: {csvs}")
    if not (fid_gap <= EVAL_FID_REL_TOL and clip_gap <= EVAL_CLIP_TOL and counts[1] == launches > 0):
        raise AssertionError(f"eval-cli: FID gap {fid_gap}, CLIP gap {clip_gap}, launches {counts}, tree {launches}")
    return counts


def write_reference_pickle(path: Path, grid: VoxelGrid) -> dict:
    """A reference Vox-E save-info dict (reference volumetric_model.py:85-99)
    for `grid` with an attn channel, pickled while stub thre3d_atom modules
    hold its NamedTuples and activation function. Returns the arrays."""
    import types
    from typing import NamedTuple

    class VoxelSize(NamedTuple):
        x_size: float
        y_size: float
        z_size: float

    class VoxelGridLocation(NamedTuple):
        x_coord: float
        y_coord: float
        z_coord: float

    class CameraBounds(NamedTuple):
        near: float
        far: float

    class CameraIntrinsics(NamedTuple):
        height: int
        width: int
        focal: float

    def softplus(x):
        return F.softplus(x)

    modules = {name: types.ModuleType(name) for name in (
        "thre3d_atom", "thre3d_atom.thre3d_reprs", "thre3d_atom.thre3d_reprs.voxels", "thre3d_atom.utils",
        "thre3d_atom.utils.imaging_utils")}
    for module, objs in (("thre3d_atom.thre3d_reprs.voxels", (VoxelSize, VoxelGridLocation, softplus)),
                         ("thre3d_atom.utils.imaging_utils", (CameraBounds, CameraIntrinsics))):
        for obj in objs:
            obj.__module__, obj.__qualname__ = module, obj.__name__
            setattr(modules[module], obj.__name__, obj)
    arrays = {"_densities": grid.densities.cpu(), "_features": grid.features.cpu(),
              "attn": torch.where(grid.densities.cpu() > 0.0, 1.0, -20.0)}
    res = grid.grid_dims[0]
    payload = {"thre3d_repr": {"state_dict": arrays, "config_dict": {
        "grid_dims": (res,) * 3, "feature_dims": 3, "voxel_size": VoxelSize(*grid.config.voxel_size),
        "grid_location": VoxelGridLocation(0.0, 0.0, 0.0), "density_preactivation": torch.abs,
        "density_postactivation": softplus, "expected_density_scale": 1.0}},
        "extra_info": {"camera_bounds": CameraBounds(2.0, 6.0), "camera_intrinsics": CameraIntrinsics(
            SCENE, SCENE, float(SCENE)), "hemispherical_radius": 4.0311}}
    sys.modules.update(modules)
    try:
        torch.save(payload, path)
    finally:
        for name in modules:
            del sys.modules[name]
    return {k: v.numpy() for k, v in arrays.items()}


def phase_import_reference(dev, workdir: Path) -> tuple:
    """The reference-checkpoint importer on a reference-style pickle of the
    160^3 demo grid (SH degree 0, an attn channel, camera bounds and
    intrinsics in its extra_info): the import on the host, the checkpoint
    read back onto the card (arrays bitwise), one 400^2 frame of it through
    the exact renderer and the compositing kernel. Returns the (flash,
    compositing) launches."""
    reset_counts()  # counts from here to the end of the frame
    src = write_reference_pickle(workdir / "reference.pth", make_demo_grid(GRID_RES, device="cpu"))
    t0 = time.perf_counter()
    logged(import_cli.main, ["-i", str(workdir / "reference.pth"), "-o", str(workdir / "imported.pth")])
    import_s = time.perf_counter() - t0
    model, extra = load_volumetric_model(workdir / "imported.pth", device=dev)
    same = {name: bool(np.array_equal(getattr(model.grid, name).cpu().numpy(), src[key]))
            for name, key in (("densities", "_densities"), ("features", "_features"), ("attn", "attn"))}
    intr = CameraIntrinsics(*[int(v) for v in extra["camera_intrinsics"][:2]], float(extra["camera_intrinsics"][2]))
    out = model.render(intr, pose_spherical(40.0, 30.0, extra["hemispherical_radius"]), use_fused_kernel=True)
    torch.cuda.synchronize()
    flash, launches = fa.LAUNCHES, comp.LAUNCHES
    acc = out.extra[EXTRA_ACCUMULATED_WEIGHTS]
    log("import-reference", grid=list(model.grid.grid_dims), import_s=import_s, bitwise=same, extra_info=extra,
        frame=list(out.colour.shape), colour_mean=float(out.colour.mean()),
        object_pixels=int((acc > 0.5).sum()), composite_launches=launches, flash_launches=flash)
    if not (all(same.values()) and out.colour.shape == (SCENE, SCENE, 3) and torch.isfinite(out.colour).all()
            and launches > 0):
        raise AssertionError(f"import-reference: bitwise {same}, frame {tuple(out.colour.shape)}, {launches} launches")
    return flash, launches


ORACLE_RES, ORACLE_BASE, ORACLE_ITERS = 160, 256, 300  # the README's production runs of both demos
ORACLE_PROFILE_STEPS = 10


def phase_oracle_edit(dev, workdir: Path) -> tuple:
    """demo_oracle_edit at 160^3 / 256^2 base, 300 iterations (its
    production run): the colour distance to the target at least halved,
    density correlation > 0.9; ms a step, then the device's busy share over
    ORACLE_PROFILE_STEPS more steps under torch.profiler. Returns the demo's
    (flash, compositing) launches (the compositing ones: its exact frames)."""
    from voxe_tpu_torch.tools import oracle

    reset_counts()
    m, _ = logged(demo_edit_tool.main, ["--res", str(ORACLE_RES), "--base", str(ORACLE_BASE), "--iters",
                                        str(ORACLE_ITERS), "--out", str(workdir / "demo_oracle_160"), "--device",
                                        str(dev)])
    flash, launches = fa.LAUNCHES, comp.LAUNCHES
    log("oracle-edit", **m, composite_launches=launches, flash_launches=flash, tpu_record_density_correlation=0.999,
        card=card_line().replace(" ", "_"))
    grid = make_demo_grid(ORACLE_RES, device=dev)
    sds = oracle.MaskedOracleSDS(oracle.GOLDEN, device=dev)
    profile_call(lambda: oracle.run_oracle_sds(grid, sds, oracle.demo_render_config(), (ORACLE_BASE,) * 2,
                                               ORACLE_PROFILE_STEPS, 1), ORACLE_PROFILE_STEPS, m["ms_per_step"])
    if not (m["colour_distance_after"] < 0.5 * m["colour_distance_before"] and m["density_correlation"] > 0.9
            and launches > 0):
        raise AssertionError(f"oracle-edit: {m}, {launches} launches")
    return flash, launches


def phase_oracle_local(dev, workdir: Path) -> tuple:
    """demo_oracle_local_edit at its record's configuration (160^3, 256^2
    base, 300 SDS + 300 refinement iterations): the JAX test's bounds (body
    restored, IoU > 0.5, hat feature delta > 0.1, body mislabel < 0.2),
    logged beside the TPU record. Returns the (flash, compositing) launches."""
    reset_counts()
    m, _ = logged(demo_local_tool.main, ["--res", str(ORACLE_RES), "--base", str(ORACLE_BASE), "--sds_iters",
                                         str(ORACLE_ITERS), "--refine_iters", str(ORACLE_ITERS), "--out",
                                         str(workdir / "demo_oracle_local_160"), "--device", str(dev)])
    flash, launches = fa.LAUNCHES, comp.LAUNCHES
    log("oracle-local", **m, composite_launches=launches, flash_launches=flash, tpu_record=json.dumps(
        dict(iou=0.871, body_restored=True, body_mislabel_frac=0.0, hat_feature_delta=3.45)).replace(" ", ""),
        card=card_line().replace(" ", "_"))
    if not (m["body_restored"] and m["iou"] > 0.5 and m["hat_feature_delta"] > 0.1 and m["body_mislabel_frac"] < 0.2
            and launches > 0):
        raise AssertionError(f"oracle-local: {m}, {launches} launches")
    return flash, launches


QUALITY_ITERS, QUALITY_RECORD_ITERS = 75, 150  # a stage: cut from the record's 150 to keep the script's time


def phase_quality_recon(dev, workdir: Path) -> tuple:
    """quality_run_shearwarp at the record's widths (160^3 grid, 128^2
    images, 16 views, the 2x base), QUALITY_ITERS a stage (the record's
    150 cut to half, logged): the coarse stages
    on the CPU, the last on the card through the compositing kernel, then
    the held-out and train views through the exact renderer. Held-out PSNR
    finite and above 25 dB. Returns the (flash, compositing) launches."""
    reset_counts()
    result, _ = logged(quality_tool.main, ["--grid", str(GRID_RES), "--image", "128", "--views", "16", "--iters",
                                           str(QUALITY_ITERS), "--out", str(workdir / "quality_sw"), "--device",
                                           str(dev)])
    flash, launches = fa.LAUNCHES, comp.LAUNCHES
    log("quality-recon", **result, composite_launches=launches, flash_launches=flash,
        record_iters_per_stage=QUALITY_RECORD_ITERS,
        tpu_record_heldout_psnr=36.20, card=card_line().replace(" ", "_"))
    if not (np.isfinite(result["heldout_psnr"]) and result["heldout_psnr"] > 25.0 and launches > 0):
        raise AssertionError(f"quality-recon: {result}, {launches} launches")
    return flash, launches


def build_all() -> None:
    """One nvcc per kernel source, all started together."""
    libs = {"flash_attn_fwd": fa.build, "flash_attn_bwd": fa.build_bwd, "composite_fwd": comp.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(fn, verbose=True) for name, fn in libs.items()}
        for name, fut in futures.items():
            fut.result()  # raises if nvcc failed
    log("build", kernels=list(libs), seconds=time.perf_counter() - t0)
    for name, lib in (("flash_attn_fwd", fa._LIB), ("flash_attn_bwd", fa._LIB_BWD), ("composite_fwd", comp._LIB)):
        if lib.report is None:
            log("ptxas", lib=name, note="not built in this process (a library of the same source was there)")
            continue
        for entry, props in cuda_build.ptxas_summary(lib.report).items():
            m = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", entry)
            log("ptxas", lib=name, kernel=m.group(1) if m else entry, d=m.group(2) if m else None, **props)


BWD_PHASES = ("flash-bwd-kernel", "unet-grad")  # the only phases that run the flash backward


def timed(name: str, fn, *args):
    """Run one phase; print its seconds. Every phase but the flash kernels'
    checks (which hold the kernels against it) must leave the plain attention
    uncalled on the card, and every phase but the backward's check and
    unet-grad must launch no flash backward (no other path differentiates
    through the UNet)."""
    global BWD_IN_PHASE
    fa.REFERENCE_ON_CUDA = fa.LAUNCHES_BWD = BWD_IN_PHASE = 0
    t0 = time.perf_counter()
    out = fn(*args)
    bwd = BWD_IN_PHASE + fa.LAUNCHES_BWD
    log("phase-seconds", name=name, seconds=time.perf_counter() - t0, plain_attention_calls=fa.REFERENCE_ON_CUDA,
        flash_bwd_launches=bwd)
    if name not in ("flash-kernel", "flash-bwd-kernel") and fa.REFERENCE_ON_CUDA != 0:
        raise AssertionError(f"{name}: the plain attention ran {fa.REFERENCE_ON_CUDA} times on the card")
    if name not in BWD_PHASES and bwd != 0:
        raise AssertionError(f"{name}: the flash backward launched {bwd} times")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    log("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc.stdout.strip().splitlines()[-1].replace(" ", "_"),
        card=card_line().replace(" ", "_"), count=torch.cuda.device_count())
    timed("build", build_all)  # prints ptxas' registers / shared memory / spills when it builds
    flash_row = timed("flash-kernel", phase_flash_kernel, dev)
    bwd_row = timed("flash-bwd-kernel", phase_flash_bwd_kernel, dev)
    comp_row = timed("composite-kernel", phase_composite_kernel, dev)
    timed("small-check", phase_small_check, dev)
    timed("small-check-recon", phase_small_check_recon, dev)
    flash, composite = timed("main-path", phase_main, dev)
    flash_row["launches"] = flash
    by_path = {"edit-step": {"flash_attn_fwd": flash, "composite_fwd": composite}}
    with tempfile.TemporaryDirectory(prefix="voxe_chip_smoke_") as tmp:
        work = Path(tmp)

        def no_unet(name, fn, *args):  # a path without a UNet: the flash forward must not launch
            flash, composite = timed(name, fn, *args)
            if flash != 0:
                raise AssertionError(f"{name}: the flash forward launched {flash} times on a path without a UNet")
            by_path[name] = {"flash_attn_fwd": flash, "composite_fwd": composite}

        (flash, comp_row["launches"]), recon_ctx = timed("recon-main-path", phase_recon_main, dev, work)
        by_path["recon"] = {"flash_attn_fwd": flash, "composite_fwd": comp_row["launches"]}
        no_unet("recon-kstep", phase_recon_kstep, recon_ctx)
        del recon_ctx
        no_unet("recon-cli", phase_recon_cli, work)
        no_unet("recon-cli-resume", phase_recon_cli_resume, work)
        no_unet("recon-streaming", phase_recon_streaming, dev, work)
        for name, shear_warp in (("render-cli-exact", False), ("render-cli-shear-warp", True)):
            no_unet(name, phase_render_cli, work, shear_warp)
        no_unet("feature-grid", phase_feature_grid, dev, work)
        snapshot = timed("sd-weights", phase_sd_weights, dev, work)
        for name, fn, args in (("sd-sample", phase_sd_sample, (dev, work, snapshot)),
                               ("p2p-hook", phase_p2p_hook, (dev, snapshot))):
            flash, composite = timed(name, fn, *args)
            by_path[name] = {"flash_attn_fwd": flash, "composite_fwd": composite}
        flash, bwd_row["launches"] = timed("unet-grad", phase_unet_grad, dev, snapshot)
        by_path["unet-grad"] = {"flash_attn_fwd": flash, "flash_attn_bwd": bwd_row["launches"], "composite_fwd": 0}
        for name, data_pose in (("edit-cli", False), ("edit-data-pose", True)):
            flash, composite = timed(name, phase_edit_cli, dev, work, snapshot, data_pose)
            by_path[name] = {"flash_attn_fwd": flash, "composite_fwd": composite}
        snapshot14 = timed("sd14-weights", phase_sd_weights, dev, work, "1.4")
        for name, (flash, composite) in timed("refine-cli", phase_refine_cli, dev, work, snapshot14).items():
            by_path[name] = {"flash_attn_fwd": flash, "composite_fwd": composite}
        for name, (flash, composite) in timed("refine-kstep", phase_refine_kstep, dev, work, snapshot14).items():
            by_path[name] = {"flash_attn_fwd": flash, "composite_fwd": composite}
        flash, composite = timed("edit-refine", phase_edit_refine, dev, work, snapshot, snapshot14)
        by_path["edit-refine"] = {"flash_attn_fwd": flash, "composite_fwd": composite}
        for name, (flash, composite) in timed("render-attn-cli", phase_render_attn_cli, work, snapshot14).items():
            by_path[name] = {"flash_attn_fwd": flash, "composite_fwd": composite}
        no_unet("grid-refine", phase_grid_refine, dev, work, snapshot14)
        flash, composite = timed("parallel-nccl", phase_parallel_nccl, dev, work)
        by_path["parallel-nccl"] = {"flash_attn_fwd": flash, "composite_fwd": composite}
        timed("bf16-mesh-route", phase_bf16_mesh_route, dev)
        no_unet("eval-cli", phase_eval_cli, dev, work)
        no_unet("import-reference", phase_import_reference, dev, work)
        no_unet("oracle-edit", phase_oracle_edit, dev, work)
        no_unet("oracle-local", phase_oracle_local, dev, work)
        no_unet("quality-recon", phase_quality_recon, dev, work)
    comp_row["max_abs_err"] = max(comp_row["max_abs_err"], timed("shape-sweep", phase_shape_sweep, dev))
    for row in (flash_row, bwd_row, comp_row):  # timed() held flash_attn_bwd at 0 on every other path
        row["launches_by_path"] = {path: counts.get(row["name"], 0) for path, counts in by_path.items()}
    print(json.dumps({"kernels": [flash_row, bwd_row, comp_row]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke test of the PyTorch port (voxe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero; there is no CPU path):
  1. environment: torch / CUDA / nvcc versions, card name and power limit;
  2. build every hand-written kernel from the checkout's sources (nvcc);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes plus a ragged shape; kernel, plain and library
     (timed only, never used by the port) times;
  4. small-input check: the tiny-config edit step's grid gradient on the
     card against the same step on the CPU (f32, same weights and draws);
  5. the main path at full width: the SDS edit step (SD 2.0 at its
     published widths with seeded random weights, 160^3 grid, 384^2 base)
     through `make_sds_train_multi_step`: one warm-up call, then timed
     calls; launch counts, median ms/step with its spread, peak memory,
     and a per-layer breakdown;
  6. the `kernels` JSON line, the card line, and the final JSON line.
Imports nothing from JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize
from voxe_tpu_torch.models.sd.sds import DIRECTION_PROMPTS, StableDiffusion
from voxe_tpu_torch.ops import flash_attention as fa
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.render.shearwarp import lane_aligned_res, orient_base_image, render_shear_warp
from voxe_tpu_torch.train import sds as train_sds
from voxe_tpu_torch.train.losses import density_correlation_loss
from voxe_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, CameraPose, pose_spherical
from voxe_tpu_torch.utils.misc import compute_expected_density_scale_for_relu_field_grid

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
# (shape, q scale): the main shape, a ragged d=128 shape, and peaked scores
# (std 4) so the running max moves between key tiles and the rescale matters
CHECKS = ((MAIN_SHAPE, 1.0), ((1, 2500, 2, 128), 1.0), ((1, 1000, 3, 64), 4.0))
STEPS_PER_CALL, TIMED_CALLS = 3, 8
GRID_RES, BASE, SD_VERSION = 160, lane_aligned_res(400), "2.0"


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


def phase_kernels(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    errs = []
    for shape, q_scale in CHECKS:
        q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(3))
        q = q * q_scale
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v).float()
        err = float((out.float() - ref).abs().max())
        rel = err / float(ref.abs().max())
        log("kernel-check", kernel="flash_attn_fwd", shape=list(shape), q_scale=q_scale,
            max_abs_err=err, max_abs_ref=float(ref.abs().max()), rel_err=rel, rel_tol=FLASH_REL_TOL)
        if not rel < FLASH_REL_TOL:
            raise AssertionError(f"flash_attn_fwd disagrees with its plain version: {rel}")
        errs.append(err)
    B, L, Hh, D = MAIN_SHAPE
    q, k, v = (torch.randn(MAIN_SHAPE, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = time_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4.0 * B * Hh * L * L * D
    nbytes = 4.0 * B * L * Hh * D * 2
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    row = dict(
        name="flash_attn_fwd", route="cuda", source="voxe_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="voxe_tpu/models/sd/unet.py:163", launches=0, max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=library_ms,
    )
    log("kernel-time", kernel="flash_attn_fwd", shape=list(MAIN_SHAPE), ms=ms, plain_ms=plain_ms,
        sdpa_ms=library_ms, bound_ms=row["bound_ms"], tflops=flops / ms / 1e9)
    return row


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


def phase_main(dev) -> dict:
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
    fa.reset_launches()  # counts from here to the end of the main path's run
    m = multi(grid, text_by_dir, ref_d, ref_f, t_bounds, gen)  # warm-up call
    torch.cuda.synchronize()
    losses, call_ms = [float(m["total_loss"])], []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        m = multi(grid, text_by_dir, ref_d, ref_f, t_bounds, gen)
        losses.append(float(m["total_loss"]))  # reads the loss: a device sync
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3 / STEPS_PER_CALL)
    launches = fa.LAUNCHES
    steps = STEPS_PER_CALL * (1 + TIMED_CALLS)
    ms_step = float(np.median(call_ms))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    moved = float((grid.densities.detach() - before).abs().max())
    log("main-path", steps=steps, ms_per_step_median=ms_step, ms_per_step_min=min(call_ms),
        ms_per_step_max=max(call_ms), timed_calls=TIMED_CALLS, peak_mem_gib=peak_gib,
        flash_launches=launches, losses=losses, grid_max_change=moved)
    if launches != 5 * steps:
        raise AssertionError(f"flash kernel launched {launches} times in {steps} steps, want 5 per step")
    if not all(np.isfinite(losses)) or not moved > 0.0:
        raise AssertionError(f"main path: losses {losses}, grid change {moved}")
    breakdown(sd, grid, text_by_dir[3], ref_d)
    profile_call(lambda: multi(grid, text_by_dir, ref_d, ref_f, t_bounds, gen), STEPS_PER_CALL, ms_step)
    return {"launches": launches}


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
    log("profile", steps=steps, wall_ms_per_step=wall_ms / steps, device_busy_ms_per_step=busy_ms / steps,
        idle_share_profiled=1.0 - busy_ms / wall_ms,
        idle_share_vs_unprofiled_step=1.0 - busy_ms / steps / ms_step,
        kernel_launches_per_step=sum(k[2] for k in kernels) / steps)
    print("[profile-top] " + json.dumps(
        [{"kernel": k[:90], "ms_per_step": t / steps, "calls_per_step": c / steps} for k, t, c in top]
    ), flush=True)


def breakdown(sd, grid, text, ref_d) -> None:
    """Per-layer device time of one edit step at a fixed pose, with a
    synchronised host clock around each layer (median of 3)."""
    pose = pose_spherical(30.0, 40.0, 4.0311)
    rot = torch.as_tensor(pose.rotation, device=grid.densities.device)
    cam = CameraPose(rot, torch.as_tensor(pose.translation, device=rot.device))
    gen = torch.Generator(device=rot.device).manual_seed(2)
    parts = {}

    def clock(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    nvcc = subprocess.run([fa._nvcc(), "--version"], capture_output=True, text=True, check=True)
    log("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc.stdout.strip().splitlines()[-1].replace(" ", "_"),
        card=card_line().replace(" ", "_"), count=torch.cuda.device_count())
    t0 = time.perf_counter()
    fa.build(verbose=True)  # prints ptxas' registers / shared memory / spills when it builds
    log("build", kernel="flash_attn_fwd", seconds=time.perf_counter() - t0)
    row = phase_kernels(dev)
    phase_small_check(dev)
    row.update(phase_main(dev))
    print(json.dumps({"kernels": [row]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

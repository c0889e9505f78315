"""Analytic oracle denoisers and the hat scene for the weight-free edit
demos (counterparts of tests/test_sds_oracle_edit.py:39-56 and
tools/demo_oracle_local_edit.py:44-77).

For a delta target distribution at an image x*, the exact noise predictor
is eps_hat(x_t, t) = (x_t - sqrt(abar_t) x*) / sqrt(1 - abar_t). With
x_t = sqrt(abar) x + sqrt(1 - abar) eps this gives
eps_hat - eps = sqrt(abar) / sqrt(1 - abar) (x - x*), so the injected SDS
gradient w(t) (eps_hat - eps) points from the render x toward x*: what SD's
UNet gives for a text prompt (reference sds.py:174-234). `OracleSDS` is
duck-typed to the port's `StableDiffusion` where the edit steps call it
(`sds_loss(text_embeddings, pred_rgb, t, guidance_scale, generator=,
noise=, vae_eps=)`), so the real train steps
(`train/sds.py::make_sds_train_step_shearwarp[_data]`) run with it; pixel
space is its latent space. Its noise comes from the step's
`torch.Generator`, or is passed in as `noise` ([B, H, W, 3]).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize
from voxe_tpu_torch.models.sd.scheduler import DDIMScheduler
from voxe_tpu_torch.models.sd.sds import specify_gradient
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.train.recon import make_adam
from voxe_tpu_torch.train.sds import make_sds_train_step_shearwarp
from voxe_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, pose_spherical, to8b
from voxe_tpu_torch.utils.constants import EXTRA_ACCUMULATED_WEIGHTS

GOLDEN = (0.95, 0.75, 0.1)  # the demos' "make it golden" target
DEMO_RADIUS = 4.031


class OracleSDS:
    """StableDiffusion stand-in with the analytic noise predictor of a delta
    distribution at a constant-colour image."""

    def __init__(self, target_rgb: Sequence[float], num_train_timesteps: int = 1000, device="cuda"):
        self.scheduler = DDIMScheduler(num_train_timesteps, 0.00085, 0.012, device=device)
        self.alphas = self.scheduler.alphas_cumprod
        self.target = torch.tensor(target_rgb, dtype=torch.float32, device=device)

    def target_image(self, x0: torch.Tensor) -> torch.Tensor:
        """x* for a (detached) render x0 [B, H, W, 3]."""
        return self.target.expand(x0.shape)

    def sds_loss(
        self,
        text_embeddings,
        pred_rgb: torch.Tensor,  # [B, H, W, 3] in [0, 1], differentiable
        t,
        guidance_scale: float = 100.0,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        vae_eps=None,
    ) -> torch.Tensor:
        """A zero whose gradient w.r.t. `pred_rgb` is (1 - abar_t)
        (eps_hat - eps), NaN-free; `text_embeddings`, `guidance_scale` and
        `vae_eps` are unused (no text, no VAE)."""
        del text_embeddings, guidance_scale, vae_eps
        x0 = pred_rgb.detach()
        abar = self.alphas[t]
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device)
        x_t = torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * noise
        eps_hat = (x_t - torch.sqrt(abar) * self.target_image(x0)) / torch.sqrt(1.0 - abar)
        grad = (1.0 - abar) * (eps_hat - noise)  # w(t) = 1 - abar, as in SD
        return specify_gradient(pred_rgb, torch.nan_to_num(grad))


class MaskedOracleSDS(OracleSDS):
    """Target = the colour on object pixels (min channel < 0.85), white on
    the background: the delta-target analog of a prompt that describes the
    OBJECT (a real SD score does not push empty space toward the prompt's
    colour; an unmasked constant target does, hazing the background). The
    demos' oracle (tools/demo_oracle_edit.py:70-89)."""

    def target_image(self, x0: torch.Tensor) -> torch.Tensor:
        is_obj = torch.amin(x0, dim=-1, keepdim=True) < 0.85
        return torch.where(is_obj, self.target, torch.ones((), device=x0.device))


def make_hat_scene(res: int, world_size: float = 3.0, device="cuda"):
    """Sphere body + cone 'hat' on top, distinct colours; returns
    (VoxelGrid, hat_mask [res, res, res] bool, body_mask) with the JAX
    demo's arrays bit for bit."""
    half = world_size / 2
    x = np.linspace(-half, half, res)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")

    body = np.sqrt(X**2 + Y**2 + (Z + 0.35) ** 2) < 0.8
    # cone apex up: radius shrinks with height above the body
    hz0, hz1 = 0.42, 1.15
    frac = np.clip((Z - hz0) / (hz1 - hz0), 0.0, 1.0)
    hat = (np.sqrt(X**2 + Y**2) < 0.55 * (1.0 - frac)) & (Z >= hz0) & (Z <= hz1)
    hat &= ~body

    density = np.where(body | hat, 40.0, -15.0).astype(np.float32)
    rgb = np.zeros((*X.shape, 3), dtype=np.float32)
    rgb[body] = (2.5, -1.5, -1.5)  # red body (pre-sigmoid logits)
    rgb[hat] = (-1.5, 2.5, -1.5)  # green hat

    config = VoxelGridConfig(
        voxel_size=VoxelSize(*([world_size / res] * 3)),
        density_preactivation="identity",
        density_postactivation="softplus",
        expected_density_scale=1.0,
    )
    grid = VoxelGrid(torch.from_numpy(density[..., None]).to(device), torch.from_numpy(rgb).to(device), config)
    return grid, hat, body


def demo_render_config() -> SHVoxGridRenderConfig:
    """The demos' render configuration (tools/demo_oracle_edit.py:56-63)."""
    return SHVoxGridRenderConfig(
        num_samples_per_ray=96,
        camera_bounds=CameraBounds(0.5, 10.0),
        white_bkgd=True,
        perturb_sampled_points=False,
        render_num_samples_per_ray=128,
        parallel_rays_chunk_size=16384,
    )


def demo_pose(rng: np.random.Generator):
    """A hemisphere pose from the demos' numpy draw (yaw, then pitch in
    [15, 75) degrees)."""
    return pose_spherical(float(rng.random() * 360.0), 15.0 + float(rng.random() * 60.0), DEMO_RADIUS)


def pose_tensors(pose, device):
    """(rotation [3, 3], translation [3, 1]) f32 on `device`."""
    return (torch.as_tensor(pose.rotation, dtype=torch.float32, device=device),
            torch.as_tensor(pose.translation, dtype=torch.float32, device=device).reshape(3, 1))


def render_frame(grid: VoxelGrid, rcfg: SHVoxGridRenderConfig, intr: CameraIntrinsics, yaw: float):
    """An exact frame from (yaw, pitch 30) through the compositing kernel
    (its plain version on the CPU): (uint8 [H, W, 3], colour, accumulated
    weights), the last two on the grid's device."""
    out = VolumetricModel(grid, rcfg).render(intr, pose_spherical(yaw, 30.0, DEMO_RADIUS), use_fused_kernel=True)
    return to8b(out.colour.cpu().numpy()), out.colour, out.extra[EXTRA_ACCUMULATED_WEIGHTS]


def object_colour_distance(colour: torch.Tensor, acc: torch.Tensor, target: Sequence[float]) -> float:
    """|mean colour over object pixels (accumulated weight > 0.5) - target|."""
    mask = acc.reshape(-1) > 0.5
    if int(mask.sum()) <= 20:
        raise ValueError(f"the frame shows {int(mask.sum())} object pixels")
    mean = colour.reshape(-1, 3)[mask].mean(0).cpu().numpy()
    return float(np.linalg.norm(mean - np.asarray(target)))


def sync(dev: torch.device) -> None:
    """Wait for the card (a no-op on the CPU): the demos' host clocks read
    finished work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_oracle_sds(
    grid: VoxelGrid,
    oracle: OracleSDS,
    rcfg: SHVoxGridRenderConfig,
    base_hw: tuple,
    iters: int,
    seed: int,
    lr: float = 0.05,
    density_correlation_weight: float = 5.0,
    on_step: Optional[Callable[[int, dict], None]] = None,
    rng: Optional[np.random.Generator] = None,
) -> dict:
    """`iters` steps of the shear-warp SDS edit (`make_sds_train_step_shearwarp`,
    Adam at `lr`, density correlation against the grid as given) with the
    oracle, in place: hemisphere poses from the numpy Generator `rng`, t in
    [20, 980) from a CPU torch.Generator, the oracle's noise from one on the
    grid's device, each seeded with `seed` (`rng` too when not given). Returns {"ms_per_step": the
    host-clock mean of every step after the first (synced at the end),
    "first_step_ms"}."""
    dev = grid.densities.device
    ref_d, ref_f = grid.densities.detach().clone(), grid.features.detach().clone()
    step = make_sds_train_step_shearwarp(oracle, rcfg, make_adam(grid, lr), tuple(base_hw),
                                         density_correlation_weight=density_correlation_weight)
    rng = np.random.default_rng(seed) if rng is None else rng
    t_gen = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    text = torch.zeros((2, 77, 8), device=dev)
    t0 = t1 = time.perf_counter()
    for i in range(iters):
        pose = demo_pose(rng)
        t = int(torch.randint(20, 980, (), generator=t_gen))
        rot, trans = pose_tensors(pose, dev)
        metrics = step(grid, text, rot, trans, ref_d, ref_f, t, generator=gen)
        if i == 0:
            sync(dev)
            t1 = time.perf_counter()
        if on_step is not None:
            on_step(i + 1, metrics)
    sync(dev)
    t2 = time.perf_counter()
    return {"first_step_ms": (t1 - t0) * 1e3, "ms_per_step": (t2 - t1) * 1e3 / max(iters - 1, 1)}

"""DDIM noise schedule (counterpart of voxe_tpu/models/sd/scheduler.py): the
scaled-linear betas, `alphas_cumprod`, `add_noise`, the inference
`timesteps` (shifted by `steps_offset`, as the diffusers scheduler the SD
checkpoints ship with) and the DDIM sampling `step` (deterministic at
eta = 0, with the DDIM paper's sigma_t noise at eta > 0)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class DDIMScheduler:
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        steps_offset: int = 1,
        device="cuda",
    ):
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
        self.alphas_cumprod = torch.as_tensor(
            np.cumprod(1.0 - betas), dtype=torch.float32, device=device
        )
        self.final_alpha_cumprod = torch.tensor(1.0, dtype=torch.float32, device=device)

    def add_noise(self, latents, noise, t):
        """q(x_t | x_0) = sqrt(a_t) x0 + sqrt(1 - a_t) eps; `t` an int or a
        0-d integer tensor."""
        a = self.alphas_cumprod[t]
        return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise

    def step(
        self,
        noise_pred: torch.Tensor,
        t: int,
        t_prev: int,
        latents: torch.Tensor,
        eta: float = 0.0,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """DDIM update x_t -> x_{t_prev} (elementwise, any layout); t_prev < 0
        is the last step (a_prev = 1). With eta > 0 the sigma_t noise is
        `noise` when given, else drawn from `generator`; one of them is
        required."""
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[t_prev] if t_prev >= 0 else self.final_alpha_cumprod
        x0_pred = (latents - torch.sqrt(1.0 - a_t) * noise_pred) / torch.sqrt(a_t)
        if eta > 0.0:
            if noise is None and generator is None:
                raise ValueError("stochastic DDIM (eta > 0) needs a generator or the noise")
            # sigma_t = eta sqrt((1 - a_prev) / (1 - a_t)) sqrt(1 - a_t / a_prev)
            variance = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
            sigma = eta * torch.sqrt(variance)
            dir_xt = torch.sqrt(1.0 - a_prev - sigma**2) * noise_pred
            if noise is None:
                noise = torch.randn(
                    latents.shape, generator=generator, device=latents.device, dtype=latents.dtype
                )
            return torch.sqrt(a_prev) * x0_pred + dir_xt + sigma * noise
        return torch.sqrt(a_prev) * x0_pred + torch.sqrt(1.0 - a_prev) * noise_pred

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """Descending int64 timesteps, arange(N) * (T // N) + steps_offset
        clipped to [0, T - 1]: [981, 961, ..., 1] for N = 50."""
        step = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(np.int64)
        ts = np.clip(ts + self.steps_offset, 0, self.num_train_timesteps - 1)
        return torch.as_tensor(ts, dtype=torch.int64)

"""DDPM noise schedule (counterpart of voxe_tpu/models/sd/scheduler.py):
the scaled-linear betas, `alphas_cumprod` and `add_noise`. The DDIM sampling
`step` is not ported yet."""
from __future__ import annotations

import numpy as np
import torch


class DDIMScheduler:
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        device="cuda",
    ):
        self.num_train_timesteps = num_train_timesteps
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
        self.alphas_cumprod = torch.as_tensor(
            np.cumprod(1.0 - betas), dtype=torch.float32, device=device
        )

    def add_noise(self, latents, noise, t):
        """q(x_t | x_0) = sqrt(a_t) x0 + sqrt(1 - a_t) eps; `t` an int or a
        0-d integer tensor."""
        a = self.alphas_cumprod[t]
        return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise

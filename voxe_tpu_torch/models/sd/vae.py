"""AutoencoderKL, the SD VAE (counterpart of voxe_tpu/models/sd/vae.py).

Modules work on NCHW tensors (any memory format); submodule names follow the
flax module names. The encoder runs with gradients inside the SDS loss;
`decode` gives every checkpoint parameter a home. `AttnBlock` is single-head
attention at C=512 and stays a plain matmul + softmax, as in JAX.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from voxe_tpu_torch.models.sd.config import VAEConfig
from voxe_tpu_torch.models.sd.norms import GroupNorm


def conv3x3(cin: int, cout: int, stride: int = 1, padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=1e-6, silu=True)
        self.conv1 = conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=1e-6, silu=True)
        self.conv2 = conv3x3(out_channels, out_channels)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        else:
            self.conv_shortcut = None

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over flattened H*W tokens."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        flat = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(flat), self.to_k(flat), self.to_v(flat)
        scores = (q @ k.transpose(1, 2)) / math.sqrt(C)
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = self.to_out(probs @ v)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        chans = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.in_channels, chans[0])
        cin = chans[0]
        for level, ch in enumerate(chans):
            for block in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_resnet_{block}", ResnetBlock(cin, ch, g))
                cin = ch
            if level != len(chans) - 1:
                # torch-style asymmetric pad (0, 1, 0, 1) + stride-2 valid conv
                self.add_module(f"down_{level}_downsample", conv3x3(ch, ch, stride=2, padding=0))
        self.mid_resnet_0 = ResnetBlock(cin, cin, g)
        self.mid_attn = AttnBlock(cin, g)
        self.mid_resnet_1 = ResnetBlock(cin, cin, g)
        self.conv_norm_out = GroupNorm(g, cin, eps=1e-6, silu=True)
        self.conv_out = conv3x3(cin, 2 * cfg.latent_channels)

    def forward(self, x):
        cfg = self.config
        h = self.conv_in(x)
        for level in range(len(cfg.block_out_channels)):
            for block in range(cfg.layers_per_block):
                h = getattr(self, f"down_{level}_resnet_{block}")(h)
            if level != len(cfg.block_out_channels) - 1:
                h = getattr(self, f"down_{level}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        chans = tuple(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.latent_channels, chans[0])
        cin = chans[0]
        self.mid_resnet_0 = ResnetBlock(cin, cin, g)
        self.mid_attn = AttnBlock(cin, g)
        self.mid_resnet_1 = ResnetBlock(cin, cin, g)
        for level, ch in enumerate(chans):
            for block in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{level}_resnet_{block}", ResnetBlock(cin, ch, g))
                cin = ch
            if level != len(chans) - 1:
                self.add_module(f"up_{level}_upsample", conv3x3(ch, ch))
        self.conv_norm_out = GroupNorm(g, cin, eps=1e-6, silu=True)
        self.conv_out = conv3x3(cin, cfg.out_channels)

    def forward(self, z):
        cfg = self.config
        n_levels = len(cfg.block_out_channels)
        h = self.conv_in(z)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        for level in range(n_levels):
            for block in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{level}_resnet_{block}")(h)
            if level != n_levels - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode_moments(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, 3, H, W] in [-1, 1] -> (mean, logvar) latent moments."""
        mean, logvar = self.quant_conv(self.encoder(images)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, images, eps: Optional[torch.Tensor] = None):
        """Latents scaled by scaling_factor: mean + std * eps with the
        caller's sampling noise `eps` ([B, latent, h, w]), or the mean when
        eps is None."""
        mean, logvar = self.encode_moments(images)
        if eps is not None:
            mean = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        return mean * self.config.scaling_factor

    def decode(self, latents):
        """latents (scaled) -> images [B, 3, H, W] in [-1, 1]."""
        return self.decoder(self.post_quant_conv(latents / self.config.scaling_factor))

"""Stable Diffusion architecture configs (counterpart of
voxe_tpu/models/sd/config.py, identical values).

Mirrors the diffusers config.json key names of the checkpoints the reference
loads (reference: thre3d_atom/thre3d_reprs/sd.py:64-89 — SD 1.4/1.5/2.0/2.1)
so weight conversion is a straight name-map. `tiny_test_config` builds a
miniature SD (same topology, tiny widths) for weight-free tests.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"  # "quick_gelu" for SD 1.x
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # per-level attention head dim; SD 1.x uses a constant 8 heads -> (40,)*4
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    norm_num_groups: int = 32
    # which levels have cross-attn transformers (last down block is plain)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    flip_sin_to_cos: bool = True
    freq_shift: int = 0


@dataclasses.dataclass(frozen=True)
class SDConfig:
    version: str
    clip: CLIPTextConfig
    vae: VAEConfig
    unet: UNetConfig
    # DDPM forward-process noise schedule (scaled_linear for all SD versions)
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    image_size: int = 512

    @property
    def latent_size(self) -> int:
        # one 2x downsample per VAE level transition (8x for the real SD VAE)
        return self.image_size // (2 ** (len(self.vae.block_out_channels) - 1))


def _sd1x_clip() -> CLIPTextConfig:
    return CLIPTextConfig(
        hidden_size=768,
        intermediate_size=3072,
        num_hidden_layers=12,
        num_attention_heads=12,
        hidden_act="quick_gelu",
    )


SD_VERSIONS = {
    # SD 2.x: OpenCLIP-H text tower (1024 wide, 23 layers), UNet ca_dim 1024
    "2.1": SDConfig(version="2.1", clip=CLIPTextConfig(), vae=VAEConfig(), unet=UNetConfig()),
    "2.0": SDConfig(version="2.0", clip=CLIPTextConfig(), vae=VAEConfig(), unet=UNetConfig()),
    # SD 1.x: CLIP ViT-L text tower (768 wide, 12 layers), UNet ca_dim 768,
    # constant 8 attention heads
    "1.5": SDConfig(
        version="1.5",
        clip=_sd1x_clip(),
        vae=VAEConfig(),
        unet=UNetConfig(
            cross_attention_dim=768, attention_head_dim=(8, 8, 8, 8)
        ),
    ),
    "1.4": SDConfig(
        version="1.4",
        clip=_sd1x_clip(),
        vae=VAEConfig(),
        unet=UNetConfig(
            cross_attention_dim=768, attention_head_dim=(8, 8, 8, 8)
        ),
    ),
}


def tiny_test_config(image_size: int = 64) -> SDConfig:
    """A miniature SD with the full topology at toy widths — runs everywhere,
    used by the test-suite and for pipeline plumbing checks."""
    return SDConfig(
        version="tiny",
        clip=CLIPTextConfig(
            vocab_size=1024,
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
        ),
        vae=VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4),
        unet=UNetConfig(
            sample_size=image_size // 8,
            block_out_channels=(16, 32),
            layers_per_block=1,
            cross_attention_dim=32,
            attention_head_dim=(4, 8),
            norm_num_groups=4,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        ),
        image_size=image_size,
    )

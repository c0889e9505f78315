"""Stable Diffusion architecture configs (counterpart of
voxe_tpu/models/sd/config.py, identical values).

Mirrors the diffusers config.json key names of the checkpoints the reference
loads (reference: thre3d_atom/thre3d_reprs/sd.py:64-89 — SD 1.4/1.5/2.0/2.1)
so weight conversion is a straight name-map. `tiny_test_config` builds a
miniature SD (same topology, tiny widths) for weight-free tests.

SDXL base 1.0 ("xl", the port's own: the JAX package has no SDXL) adds a
second text tower with a pooled projection (`SDConfig.clip_2`), transformer
stacks deeper than one block (`UNetConfig.transformer_layers_per_block`) and
the "text_time" added embedding of the pooled text and the micro-conditioning
time ids. `tiny_xl_test_config` is its miniature.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


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
    # the pooled output's projection width (CLIPTextModelWithProjection);
    # None: no `text_projection`
    projection_dim: Optional[int] = None


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
    # transformer blocks in each level's Transformer2D (the mid block takes
    # the last level's): one number for every level, or one a level
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    # SDXL's added embedding: "text_time" adds
    # MLP(cat(pooled text, sinusoid(time ids))) to the time embedding
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 0

    def transformer_depth(self, level: int) -> int:
        """Transformer blocks a Transformer2D of `level` stacks."""
        depth = self.transformer_layers_per_block
        return depth if isinstance(depth, int) else depth[level]


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
    # SDXL's second text tower (OpenCLIP bigG with its pooled projection)
    clip_2: Optional[CLIPTextConfig] = None
    # SDXL's micro-conditioning: original size, crop top-left, target size
    add_time_ids: Optional[Tuple[int, ...]] = None

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


def _sdxl() -> SDConfig:
    """SDXL base 1.0 at its published widths (unet/, vae/, text_encoder/,
    text_encoder_2/ config.json of stabilityai/stable-diffusion-xl-base-1.0)."""
    return SDConfig(
        version="xl",
        clip=_sd1x_clip(),
        clip_2=CLIPTextConfig(
            hidden_size=1280, intermediate_size=5120, num_hidden_layers=32, num_attention_heads=20,
            hidden_act="gelu", projection_dim=1280,
        ),
        vae=VAEConfig(scaling_factor=0.13025),
        unet=UNetConfig(
            sample_size=128,
            block_out_channels=(320, 640, 1280),
            cross_attention_dim=2048,
            attention_head_dim=(5, 10, 20),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            transformer_layers_per_block=(1, 2, 10),
            addition_embed_type="text_time",
            addition_time_embed_dim=256,
            projection_class_embeddings_input_dim=2816,
        ),
        image_size=1024,
        add_time_ids=(1024, 1024, 0, 0, 1024, 1024),
    )


SD_VERSIONS["xl"] = _sdxl()


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


def tiny_xl_test_config(image_size: int = 64) -> SDConfig:
    """A miniature SDXL: three levels with no attention at the first,
    transformer depths (1, 2, 3), two 2-layer towers of different widths
    and the text_time added embedding."""
    clip = CLIPTextConfig(
        vocab_size=1024, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        hidden_act="quick_gelu",
    )
    clip_2 = CLIPTextConfig(
        vocab_size=1024, hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        projection_dim=40,
    )
    time_dim = 8
    return SDConfig(
        version="tiny-xl",
        clip=clip,
        clip_2=clip_2,
        vae=VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4, scaling_factor=0.13025),
        unet=UNetConfig(
            sample_size=image_size // 2,
            block_out_channels=(16, 32, 32),
            layers_per_block=1,
            cross_attention_dim=clip.hidden_size + clip_2.hidden_size,
            attention_head_dim=(2, 4, 4),
            norm_num_groups=4,
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            transformer_layers_per_block=(1, 2, 3),
            addition_embed_type="text_time",
            addition_time_embed_dim=time_dim,
            projection_class_embeddings_input_dim=clip_2.projection_dim + 6 * time_dim,
        ),
        image_size=image_size,
        add_time_ids=(image_size, image_size, 0, 0, image_size, image_size),
    )

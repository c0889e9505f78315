"""UNet2DConditionModel, the SD denoiser (counterpart of
voxe_tpu/models/sd/unet.py).

Modules work on NCHW tensors (channels_last memory on the card); submodule
names follow the flax module names. `attention_head_dim` is the per-level
NUMBER OF HEADS, as in the HF config field.

Self-attention goes to the port's hand-written flash kernel exactly where
voxe_tpu's `_flash_self_attention_enabled` admits the shape (q_len >= 2048,
q_len % 512 == 0, head_dim in {64, 128}); that is SD 2.x's 64x64 level, five
calls per UNet pass. Every other attention — cross-attention, the 32x32
level, and SD 1.x's 64x64 level (head_dim 40) — goes to the library's
`F.scaled_dot_product_attention`, as the JAX package calls
`jax.nn.dot_product_attention` there: q, k and v in one dtype, the default
1/sqrt(d) scale. The gate is the JAX package's, kept as it is; re-deciding
it on the card is later work.

Attention capture (the JAX package's `sow` into "attn_maps"): given a list
`attn_store`, each cross-attention of a transformer tagged "down", "mid" or
"up" takes the probs path and appends (the tag, head-averaged [B, Q, K]
f32 probabilities) to it, in call order. The probs-edit hook of the
prompt-to-prompt controllers is not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voxe_tpu_torch.models.sd.config import UNetConfig
from voxe_tpu_torch.models.sd.norms import GroupNorm
from voxe_tpu_torch.ops.flash_attention import flash_attention


def flash_self_attention_enabled(q_len: int, head_dim: int) -> bool:
    """The JAX package's gate for its Pallas flash kernel (shape part)."""
    return q_len >= 2048 and head_dim in (64, 128) and q_len % 512 == 0


def timestep_embedding(t, dim: int, flip_sin_to_cos: bool = True, freq_shift: float = 0.0):
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -np.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent) * t.float()[..., None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class ResnetBlock2D(nn.Module):
    # GroupNorm eps 1e-5 in the UNet (the VAE's are 1e-6)
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        else:
            self.conv_shortcut = None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, num_heads: int, capture: str = ""):
        super().__init__()
        self.num_heads = num_heads
        self.capture = capture  # "" or the capture tag ("down" / "mid" / "up")
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out_0 = nn.Linear(query_dim, query_dim)

    def forward(self, hidden, context=None, attn_store=None):
        """hidden [B, Q, C]; context [B, K, Dc] (None -> self-attention).
        With `attn_store` (a list) and a capture tag, the head-averaged f32
        probabilities are appended to it."""
        B, Q, C = hidden.shape
        head_dim = C // self.num_heads
        is_cross = context is not None
        context = hidden if context is None else context
        K = context.shape[1]
        # [B, T, h, d]: the kernel's layout, no head transpose
        q = self.to_q(hidden).reshape(B, Q, self.num_heads, head_dim)
        k = self.to_k(context).reshape(B, K, self.num_heads, head_dim)
        v = self.to_v(context).reshape(B, K, self.num_heads, head_dim)
        scale = 1.0 / math.sqrt(head_dim)
        if attn_store is not None and self.capture:
            probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale, dim=-1)
            attn_store.append((self.capture, probs.mean(dim=1)))
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
        elif not is_cross and flash_self_attention_enabled(Q, head_dim):
            out = flash_attention(q, k, v, scale)
        else:
            dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
            out = F.scaled_dot_product_attention(
                *(x.transpose(1, 2).to(dt) for x in (q, k, v))
            ).transpose(1, 2)  # [B, h, Q, d] -> [B, Q, h, d]
        return self.to_out_0(out.reshape(B, Q, C))


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.geglu_proj = nn.Linear(dim, dim * 8)
        self.out_proj = nn.Linear(dim * 4, dim)

    def forward(self, x):
        a, gate = self.geglu_proj(x).chunk(2, dim=-1)
        return self.out_proj(a * F.gelu(gate))  # exact erf GELU


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int, capture: str = ""):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, num_heads)  # self-attention: never captured
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, capture)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, hidden, context, attn_store=None):
        hidden = hidden + self.attn1(self.norm1(hidden))
        hidden = hidden + self.attn2(self.norm2(hidden), context, attn_store)
        return hidden + self.ff(self.norm3(hidden))


class Transformer2D(nn.Module):
    def __init__(self, channels: int, context_dim: int, num_heads: int, groups: int = 32, capture: str = ""):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks_0 = BasicTransformerBlock(channels, context_dim, num_heads, capture)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context, attn_store=None):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.transformer_blocks_0(h, context, attn_store)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        chans = cfg.block_out_channels
        n_levels = len(chans)
        g = cfg.norm_num_groups
        temb_dim = chans[0] * 4
        ctx = cfg.cross_attention_dim
        self.time_embedding_linear_1 = nn.Linear(chans[0], temb_dim)
        self.time_embedding_linear_2 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)

        skip_chans = [chans[0]]
        cin = chans[0]
        for level in range(n_levels):
            ch = chans[level]
            is_cross = cfg.down_block_types[level] == "CrossAttnDownBlock2D"
            for block in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_resnet_{block}", ResnetBlock2D(cin, ch, temb_dim, g))
                cin = ch
                if is_cross:
                    self.add_module(
                        f"down_{level}_attn_{block}",
                        Transformer2D(ch, ctx, cfg.attention_head_dim[level], g, capture="down"),
                    )
                skip_chans.append(ch)
            if level != n_levels - 1:
                self.add_module(
                    f"down_{level}_downsample", nn.Conv2d(ch, ch, 3, stride=2, padding=1)
                )
                skip_chans.append(ch)

        self.mid_resnet_0 = ResnetBlock2D(cin, cin, temb_dim, g)
        self.mid_attn = Transformer2D(cin, ctx, cfg.attention_head_dim[-1], g, capture="mid")
        self.mid_resnet_1 = ResnetBlock2D(cin, cin, temb_dim, g)

        for up_idx in range(n_levels):
            level = n_levels - 1 - up_idx
            ch = chans[level]
            is_cross = cfg.up_block_types[up_idx] == "CrossAttnUpBlock2D"
            for block in range(cfg.layers_per_block + 1):
                skip = skip_chans.pop()
                self.add_module(
                    f"up_{up_idx}_resnet_{block}", ResnetBlock2D(cin + skip, ch, temb_dim, g)
                )
                cin = ch
                if is_cross:
                    self.add_module(
                        f"up_{up_idx}_attn_{block}",
                        Transformer2D(ch, ctx, cfg.attention_head_dim[level], g, capture="up"),
                    )
            if up_idx != n_levels - 1:
                self.add_module(f"up_{up_idx}_upsample", nn.Conv2d(ch, ch, 3, padding=1))

        self.conv_norm_out = GroupNorm(g, cin, eps=1e-5)
        self.conv_out = nn.Conv2d(cin, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states, attn_store=None):
        """sample [B, in_ch, H, W]; timesteps scalar or [B]; context [B, T, Dc].
        `attn_store`: a list that receives the captured cross-attention maps."""
        cfg = self.config
        n_levels = len(cfg.block_out_channels)
        ctx = encoder_hidden_states
        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        temb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = temb.expand(sample.shape[0], -1)
        # the sinusoid and its two projections run in f32 (flax promotes the
        # bf16 kernels to the f32 input), then drop to the activation dtype
        l1, l2 = self.time_embedding_linear_1, self.time_embedding_linear_2
        temb = F.linear(temb, l1.weight.float(), l1.bias.float())
        temb = F.linear(F.silu(temb), l2.weight.float(), l2.bias.float()).to(sample.dtype)

        h = self.conv_in(sample)
        skips = [h]
        for level in range(n_levels):
            is_cross = cfg.down_block_types[level] == "CrossAttnDownBlock2D"
            for block in range(cfg.layers_per_block):
                h = getattr(self, f"down_{level}_resnet_{block}")(h, temb)
                if is_cross:
                    h = getattr(self, f"down_{level}_attn_{block}")(h, ctx, attn_store)
                skips.append(h)
            if level != n_levels - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                skips.append(h)

        h = self.mid_resnet_0(h, temb)
        h = self.mid_attn(h, ctx, attn_store)
        h = self.mid_resnet_1(h, temb)

        for up_idx in range(n_levels):
            is_cross = cfg.up_block_types[up_idx] == "CrossAttnUpBlock2D"
            for block in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{up_idx}_resnet_{block}")(h, temb)
                if is_cross:
                    h = getattr(self, f"up_{up_idx}_attn_{block}")(h, ctx, attn_store)
            if up_idx != n_levels - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{up_idx}_upsample")(h)

        return self.conv_out(F.silu(self.conv_norm_out(h)))

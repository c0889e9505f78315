"""Plain Stable Diffusion pieces: the CLIP text encoder, the VAE (encoder
used, decoder built for its weights' names) and the conditional UNet, in
float32, under the parameter names of the published diffusers and
transformers checkpoints (huggingface.co/stabilityai/stable-diffusion-2-base,
huggingface.co/CompVis/stable-diffusion-v1-4).

Every attention is the textbook product softmax(q k^T / sqrt(d)) v with the
softmax in float32; nothing fused, no library attention kernel. The UNet
can hand back the head-averaged probabilities of its cross-attentions
(down, mid and up blocks, in call order), which the refinement's token
maps read. `q` (a `precision.Rounding`) rounds the inputs of every linear,
convolution and attention product: float32 leaves them alone, the control
rounds them to float8.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import Rounding


@dataclass(frozen=True)
class SDShapes:
    """The widths of one SD release, read from the configuration file."""

    unet: dict
    vae: dict
    text_encoder: dict
    scheduler: dict
    image_size: int

    @staticmethod
    def from_config(sd: dict) -> "SDShapes":
        return SDShapes(sd["unet"], sd["vae"], sd["text_encoder"], sd["scheduler"], int(sd["image_size"]))

    @property
    def latent_size(self) -> int:
        return self.image_size // 2 ** (len(self.vae["block_out_channels"]) - 1)


class Linear(nn.Linear):
    def __init__(self, cin: int, cout: int, q: Rounding, bias: bool = True):
        super().__init__(cin, cout, bias=bias, device="meta")
        self.q = q

    def forward(self, x):
        return self.q.grads(F.linear(self.q(x), self.q(self.weight), self.bias))


class Conv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int, q: Rounding, stride: int = 1, padding: int = 0):
        super().__init__(cin, cout, k, stride=stride, padding=padding, device="meta")
        self.q = q

    def forward(self, x):
        return self.q.grads(F.conv2d(self.q(x), self.q(self.weight), self.bias, self.stride, self.padding))


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(channels, device="meta"))
        self.bias = nn.Parameter(torch.empty(channels, device="meta"))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


def layer_norm(dim: int, eps: float = 1e-5) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, device="meta")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rnd: Rounding) -> tuple:
    """[B, h, Q, d], [B, h, K, d], [B, h, K, d] -> (out [B, h, Q, d], probs)."""
    scores = rnd.grads(rnd(q) @ rnd(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores.float(), dim=-1)
    return rnd.grads(rnd(probs) @ rnd(v)), probs


# ----------------------------------------------------------------------------
# CLIP text encoder (transformers' CLIPTextModel names)
# ----------------------------------------------------------------------------


class _ClipLayer(nn.Module):
    def __init__(self, cfg: dict, q: Rounding):
        super().__init__()
        d, inner = cfg["hidden_size"], cfg["intermediate_size"]
        self.heads = cfg["num_attention_heads"]
        self.quick_gelu = cfg["hidden_act"] == "quick_gelu"
        self.layer_norm1 = layer_norm(d, cfg["layer_norm_eps"])
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.self_attn.add_module(name, Linear(d, d, q))
        self.layer_norm2 = layer_norm(d, cfg["layer_norm_eps"])
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(d, inner, q)
        self.mlp.fc2 = Linear(inner, d, q)
        self.q = q

    def forward(self, x, mask):
        B, T, C = x.shape
        a = self.self_attn
        h = self.layer_norm1(x)

        def split(t):
            return t.reshape(B, T, self.heads, C // self.heads).transpose(1, 2)

        scores = self.q(split(a.q_proj(h))) @ self.q(split(a.k_proj(h))).transpose(-1, -2)
        probs = torch.softmax(scores / math.sqrt(C // self.heads) + mask, dim=-1)
        out = (self.q(probs) @ self.q(split(a.v_proj(h)))).transpose(1, 2).reshape(B, T, C)
        x = x + a.out_proj(out)
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return x + self.mlp.fc2(h)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: dict, q: Rounding):
        super().__init__()
        d = cfg["hidden_size"]
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d, device="meta")
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d, device="meta")
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([_ClipLayer(cfg, q) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = layer_norm(d, cfg["layer_norm_eps"])
        self.text_model = tm

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        T = ids.shape[-1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(torch.arange(T, device=ids.device))
        mask = torch.triu(torch.full((T, T), float("-inf"), device=ids.device), 1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


# ----------------------------------------------------------------------------
# VAE (diffusers' AutoencoderKL names)
# ----------------------------------------------------------------------------


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, eps: float, q: Rounding, temb_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv2d(cin, cout, 3, q, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = Linear(temb_dim, cout, q)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv2d(cout, cout, 3, q, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1, q)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _VaeAttention(nn.Module):
    def __init__(self, c: int, groups: int, q: Rounding):
        super().__init__()
        self.group_norm = GroupNorm(groups, c, 1e-6)
        self.to_q, self.to_k, self.to_v = Linear(c, c, q), Linear(c, c, q), Linear(c, c, q)
        self.to_out = nn.ModuleList([Linear(c, c, q)])
        self.q = q

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, 1, H * W, C)
        out, _ = attention(self.to_q(h), self.to_k(h), self.to_v(h), self.q)
        return x + self.to_out[0](out.reshape(B, H * W, C)).reshape(B, H, W, C).permute(0, 3, 1, 2)


def _mid_block(c: int, groups: int, eps: float, q: Rounding, temb_dim=None, attn=None) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock(c, c, groups, eps, q, temb_dim) for _ in range(2)])
    mid.attentions = nn.ModuleList([attn if attn is not None else _VaeAttention(c, groups, q)])
    return mid


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict, q: Rounding):
        super().__init__()
        chans, g, n = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        lat = cfg["latent_channels"]
        self.scaling_factor = cfg["scaling_factor"]
        enc = nn.Module()
        enc.conv_in = Conv2d(cfg["in_channels"], chans[0], 3, q, padding=1)
        enc.down_blocks = nn.ModuleList()
        cin = chans[0]
        for level, ch in enumerate(chans):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(n):
                blk.resnets.append(ResnetBlock(cin, ch, g, 1e-6, q))
                cin = ch
            if level != len(chans) - 1:
                down = nn.Module()
                down.conv = Conv2d(ch, ch, 3, q, stride=2)
                blk.downsamplers = nn.ModuleList([down])
            enc.down_blocks.append(blk)
        enc.mid_block = _mid_block(cin, g, 1e-6, q)
        enc.conv_norm_out = GroupNorm(g, cin, 1e-6)
        enc.conv_out = Conv2d(cin, 2 * lat, 3, q, padding=1)
        self.encoder = enc
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1, q)
        self.post_quant_conv = Conv2d(lat, lat, 1, q)
        # the decoder is never run here; it is built so the weights' names and
        # draws match the whole published checkpoint
        dec = nn.Module()
        rev = list(reversed(chans))
        dec.conv_in = Conv2d(lat, rev[0], 3, q, padding=1)
        dec.mid_block = _mid_block(rev[0], g, 1e-6, q)
        dec.up_blocks = nn.ModuleList()
        cin = rev[0]
        for level, ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(n + 1):
                blk.resnets.append(ResnetBlock(cin, ch, g, 1e-6, q))
                cin = ch
            if level != len(rev) - 1:
                up = nn.Module()
                up.conv = Conv2d(ch, ch, 3, q, padding=1)
                blk.upsamplers = nn.ModuleList([up])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = GroupNorm(g, cin, 1e-6)
        dec.conv_out = Conv2d(cin, cfg["out_channels"], 3, q, padding=1)
        self.decoder = dec

    def encode(self, images: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """images [B, 3, H, W] in [-1, 1] -> scaled latents mean + std * eps."""
        enc = self.encoder
        h = enc.conv_in(images)
        for blk in enc.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        mid = enc.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))
        h = enc.conv_out(F.silu(enc.conv_norm_out(h)))
        mean, logvar = self.quant_conv(h).chunk(2, dim=1)
        logvar = torch.clamp(logvar, -30.0, 20.0)
        return (mean + torch.exp(0.5 * logvar) * eps) * self.scaling_factor


# ----------------------------------------------------------------------------
# UNet (diffusers' UNet2DConditionModel names)
# ----------------------------------------------------------------------------


class _CrossAttention(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int, q: Rounding):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, q, bias=False)
        self.to_k = Linear(ctx_dim, dim, q, bias=False)
        self.to_v = Linear(ctx_dim, dim, q, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim, q)])
        self.q = q

    def forward(self, x, ctx=None):
        B, Q, C = x.shape
        ctx = x if ctx is None else ctx
        d = C // self.heads

        def split(t):
            return t.reshape(B, t.shape[1], self.heads, d).transpose(1, 2)

        out, probs = attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)), self.q)
        return self.to_out[0](out.transpose(1, 2).reshape(B, Q, C)), probs


class _Transformer(nn.Module):
    def __init__(self, c: int, ctx_dim: int, heads: int, groups: int, linear_proj: bool, q: Rounding, tag: str):
        super().__init__()
        self.tag, self.linear_proj = tag, linear_proj
        self.norm = GroupNorm(groups, c, 1e-6)
        self.proj_in = Linear(c, c, q) if linear_proj else Conv2d(c, c, 1, q)
        tb = nn.Module()
        tb.norm1, tb.norm2, tb.norm3 = layer_norm(c), layer_norm(c), layer_norm(c)
        tb.attn1 = _CrossAttention(c, c, heads, q)
        tb.attn2 = _CrossAttention(c, ctx_dim, heads, q)
        tb.ff = nn.Module()
        tb.ff.net = nn.ModuleList([nn.Module(), nn.Identity(), Linear(4 * c, c, q)])
        tb.ff.net[0].proj = Linear(c, 8 * c, q)
        self.transformer_blocks = nn.ModuleList([tb])
        self.proj_out = Linear(c, c, q) if linear_proj else Conv2d(c, c, 1, q)

    def forward(self, x, ctx, store: Optional[List]):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.linear_proj:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        tb = self.transformer_blocks[0]
        h = h + tb.attn1(tb.norm1(h))[0]
        a, probs = tb.attn2(tb.norm2(h), ctx)
        if store is not None:
            store.append(probs.mean(dim=1))  # head-averaged [B, Q, K]
        h = h + a
        u, gate = tb.ff.net[0].proj(tb.norm3(h)).chunk(2, dim=-1)
        h = h + tb.ff.net[2](u * F.gelu(gate))
        if self.linear_proj:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + x


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, shift: float) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class UNet(nn.Module):
    def __init__(self, cfg: dict, q: Rounding):
        super().__init__()
        self.cfg = cfg
        chans, g, n = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        heads, ctx = cfg["attention_head_dim"], cfg["cross_attention_dim"]
        lin = bool(cfg["use_linear_projection"])
        temb = chans[0] * 4
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(chans[0], temb, q)
        self.time_embedding.linear_2 = Linear(temb, temb, q)
        self.conv_in = Conv2d(cfg["in_channels"], chans[0], 3, q, padding=1)
        self.down_blocks = nn.ModuleList()
        skips, cin = [chans[0]], chans[0]
        for level, ch in enumerate(chans):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            cross = cfg["down_block_types"][level] == "CrossAttnDownBlock2D"
            if cross:
                blk.attentions = nn.ModuleList()
            for _ in range(n):
                blk.resnets.append(ResnetBlock(cin, ch, g, 1e-5, q, temb))
                cin = ch
                if cross:
                    blk.attentions.append(_Transformer(ch, ctx, heads[level], g, lin, q, "down"))
                skips.append(ch)
            if level != len(chans) - 1:
                down = nn.Module()
                down.conv = Conv2d(ch, ch, 3, q, stride=2, padding=1)
                blk.downsamplers = nn.ModuleList([down])
                skips.append(ch)
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(cin, g, 1e-5, q, temb, _Transformer(cin, ctx, heads[-1], g, lin, q, "mid"))
        self.up_blocks = nn.ModuleList()
        for up_idx in range(len(chans)):
            level = len(chans) - 1 - up_idx
            ch = chans[level]
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            cross = cfg["up_block_types"][up_idx] == "CrossAttnUpBlock2D"
            if cross:
                blk.attentions = nn.ModuleList()
            for _ in range(n + 1):
                blk.resnets.append(ResnetBlock(cin + skips.pop(), ch, g, 1e-5, q, temb))
                cin = ch
                if cross:
                    blk.attentions.append(_Transformer(ch, ctx, heads[level], g, lin, q, "up"))
            if up_idx != len(chans) - 1:
                up = nn.Module()
                up.conv = Conv2d(ch, ch, 3, q, padding=1)
                blk.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, cin, 1e-5)
        self.conv_out = Conv2d(cin, cfg["out_channels"], 3, q, padding=1)

    def forward(self, x, t: int, ctx, store: Optional[List] = None):
        """x [B, 4, h, w], t an int, ctx [B, 77, D] -> noise prediction;
        `store` (a list) receives every cross-attention's head-averaged
        probabilities."""
        cfg = self.cfg
        tt = torch.full((x.shape[0],), t, device=x.device)
        temb = timestep_embedding(tt, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], cfg["freq_shift"])
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, store)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), ctx, store), temb)
        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, store)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


def alphas_cumprod(sched: dict, device) -> torch.Tensor:
    """The scaled-linear DDPM schedule's cumulative alphas, in float64 then
    float32."""
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, sched["num_train_timesteps"]) ** 2
    return torch.as_tensor(np.cumprod(1.0 - betas), dtype=torch.float32, device=device)


def build(shapes: SDShapes, rounding: dict) -> dict:
    """{"text_encoder", "vae", "unet"} on the meta device, each with its
    `rounding`; `weights.materialize` gives them their values."""
    return {
        "text_encoder": CLIPTextModel(shapes.text_encoder, rounding["text_encoder"]),
        "vae": AutoencoderKL(shapes.vae, rounding["vae"]),
        "unet": UNet(shapes.unet, rounding["unet"]),
    }

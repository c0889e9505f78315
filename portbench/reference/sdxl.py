"""Plain SDXL base 1.0 pieces (huggingface.co/stabilityai/stable-diffusion-xl-base-1.0,
Podell et al., arXiv:2307.01952): the two text towers, the pooled projection,
the text_time added embedding and the UNet with transformer stacks deeper
than one block, in float32 under the published diffusers and transformers
parameter names. The VAE is SD's (`portbench.reference.sd.AutoencoderKL`)
at the configuration's scaling factor.

Every attention is the textbook product softmax(q k^T / sqrt(d)) v with the
softmax in float32 (`sd.attention`); nothing fused, no library attention
kernel. `q` (a `precision.Rounding`) rounds the inputs of every linear,
convolution and attention product, as in `portbench.reference.sd`.

What the published description says, and this reference does:
- context: each tower's hidden states after its second-to-last layer
  (transformers' `hidden_states[-2]`, no final LayerNorm), side by side over
  channels (768 + 1280 = 2048);
- pooled: the second tower's final LayerNorm at the first EOS token (the
  ids' first argmax: the EOS id is the vocabulary's largest) times
  `text_projection` (no bias);
- added embedding: `add_embedding.linear_2(silu(add_embedding.linear_1(
  cat(pooled, flatten(sinusoid_256(time_ids))))))`, added to the time
  embedding, the sinusoids flipped to (cos, sin) with no shift;
- the empty negative prompt: a context and a pooled row of zeros, as the
  published pipeline gives them (`force_zeros_for_empty_prompt`).

Departures from the published pipeline, each also the program's:
- both towers read the same ids, padded with EOS; the published
  `tokenizer_2` pads with "!" (id 0), which changes the padded positions'
  states, not the layout or the cost;
- the UNet and the VAE run in float32 here; the configuration serves them
  in bfloat16 (`force_upcast` is about float16's overflow, and bfloat16
  keeps float32's exponent range);
- the time ids are the configuration's (the 1024^2 frame, uncropped).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import sd
from portbench.reference.precision import Rounding
from portbench.reference.sd import Conv2d, GroupNorm, Linear, ResnetBlock, layer_norm, timestep_embedding


class CLIPTextModel(sd.CLIPTextModel):
    """transformers' CLIPTextModel; `projection_dim` adds the pooled
    projection of CLIPTextModelWithProjection (its `text_projection`)."""

    def __init__(self, cfg: dict, q: Rounding):
        super().__init__(cfg, q)
        self.projection_dim = cfg.get("projection_dim")
        if self.projection_dim is not None:
            self.text_projection = Linear(cfg["hidden_size"], self.projection_dim, q, bias=False)

    def penultimate_and_pooled(self, ids: torch.Tensor):
        """[B, T] ids -> (hidden states after the second-to-last layer
        [B, T, D]; the projected pooled rows [B, P], or None without a
        projection)."""
        tm = self.text_model
        T = ids.shape[-1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(torch.arange(T, device=ids.device))
        mask = torch.triu(torch.full((T, T), float("-inf"), device=ids.device), 1)
        layers = list(tm.encoder.layers)
        for layer in layers[:-1]:
            x = layer(x, mask)
        if self.projection_dim is None:
            return x, None
        final = tm.final_layer_norm(layers[-1](x, mask))
        pooled = final[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]
        return x, self.text_projection(pooled)


class _Transformer(nn.Module):
    """diffusers' Transformer2DModel with linear projections and `depth`
    BasicTransformerBlocks."""

    def __init__(self, c: int, ctx_dim: int, heads: int, groups: int, depth: int, q: Rounding):
        super().__init__()
        self.norm = GroupNorm(groups, c, 1e-6)
        self.proj_in = Linear(c, c, q)
        self.transformer_blocks = nn.ModuleList()
        for _ in range(depth):
            tb = nn.Module()
            tb.norm1, tb.norm2, tb.norm3 = layer_norm(c), layer_norm(c), layer_norm(c)
            tb.attn1 = sd._CrossAttention(c, c, heads, q)
            tb.attn2 = sd._CrossAttention(c, ctx_dim, heads, q)
            tb.ff = nn.Module()
            tb.ff.net = nn.ModuleList([nn.Module(), nn.Identity(), Linear(4 * c, c, q)])
            tb.ff.net[0].proj = Linear(c, 8 * c, q)
            self.transformer_blocks.append(tb)
        self.proj_out = Linear(c, c, q)

    def forward(self, x, ctx):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C))
        for tb in self.transformer_blocks:
            h = h + tb.attn1(tb.norm1(h))[0]
            h = h + tb.attn2(tb.norm2(h), ctx)[0]
            u, gate = tb.ff.net[0].proj(tb.norm3(h)).chunk(2, dim=-1)
            h = h + tb.ff.net[2](u * F.gelu(gate))
        return self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2) + x


def _depth(cfg: dict, level: int) -> int:
    depth = cfg.get("transformer_layers_per_block", 1)
    return depth if isinstance(depth, int) else depth[level]


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel with per-level transformer depths and
    the text_time added embedding (`add_embedding`; `add_time_proj` has no
    weights)."""

    def __init__(self, cfg: dict, q: Rounding):
        super().__init__()
        self.cfg = cfg
        chans, g, n = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        heads, ctx = cfg["attention_head_dim"], cfg["cross_attention_dim"]
        temb = chans[0] * 4
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(chans[0], temb, q)
        self.time_embedding.linear_2 = Linear(temb, temb, q)
        self.add_embedding = nn.Module()
        self.add_embedding.linear_1 = Linear(cfg["projection_class_embeddings_input_dim"], temb, q)
        self.add_embedding.linear_2 = Linear(temb, temb, q)
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
                    blk.attentions.append(_Transformer(ch, ctx, heads[level], g, _depth(cfg, level), q))
                skips.append(ch)
            if level != len(chans) - 1:
                down = nn.Module()
                down.conv = Conv2d(ch, ch, 3, q, stride=2, padding=1)
                blk.downsamplers = nn.ModuleList([down])
                skips.append(ch)
            self.down_blocks.append(blk)
        last = len(chans) - 1
        self.mid_block = sd._mid_block(cin, g, 1e-5, q, temb,
                                       _Transformer(cin, ctx, heads[-1], g, _depth(cfg, last), q))
        self.up_blocks = nn.ModuleList()
        for up_idx in range(len(chans)):
            level = last - up_idx
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
                    blk.attentions.append(_Transformer(ch, ctx, heads[level], g, _depth(cfg, level), q))
            if up_idx != last:
                up = nn.Module()
                up.conv = Conv2d(ch, ch, 3, q, padding=1)
                blk.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, cin, 1e-5)
        self.conv_out = Conv2d(cin, cfg["out_channels"], 3, q, padding=1)

    def forward(self, x, t: int, ctx, pooled, time_ids):
        """x [B, 4, h, w], t an int, ctx [B, 77, 2048], pooled [B, P], time
        ids [B, 6] -> the noise prediction."""
        cfg = self.cfg
        B = x.shape[0]
        tt = torch.full((B,), t, device=x.device)
        temb = timestep_embedding(tt, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], cfg["freq_shift"])
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))
        ids = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"], cfg["flip_sin_to_cos"],
                                 cfg["freq_shift"]).reshape(B, -1)
        aug = self.add_embedding.linear_2(F.silu(self.add_embedding.linear_1(torch.cat([pooled, ids], dim=-1))))
        temb = temb + aug
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), ctx), temb)
        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


MODULES = ("text_encoder", "text_encoder_2", "vae", "unet")


def build(s: dict, rounding: dict) -> dict:
    """{"text_encoder", "text_encoder_2", "vae", "unet"} on the meta device
    for the configuration's "sd" group, each with its `rounding`;
    `weights.materialize` gives them their values."""
    return {
        "text_encoder": CLIPTextModel(s["text_encoder"], rounding["text_encoder"]),
        "text_encoder_2": CLIPTextModel(s["text_encoder_2"], rounding["text_encoder_2"]),
        "vae": sd.AutoencoderKL(s["vae"], rounding["vae"]),
        "unet": UNet(s["unet"], rounding["unet"]),
    }


@torch.no_grad()
def encode_text(towers: dict, ids: torch.Tensor, time_ids) -> tuple:
    """[N, T] conditional ids -> (context [N, 2, T, 2048], pooled [N, 2, P],
    time ids [N, 2, 6]): (unconditional, conditional) pairs with the empty
    negative prompt's zeros."""
    c1, _ = towers["text_encoder"].penultimate_and_pooled(ids)
    c2, pooled = towers["text_encoder_2"].penultimate_and_pooled(ids)
    ctx = torch.cat([c1, c2], dim=-1)
    ids6 = torch.tensor(time_ids, dtype=torch.float32, device=ids.device).expand(ids.shape[0], -1)
    return (torch.stack([torch.zeros_like(ctx), ctx], dim=1), torch.stack([torch.zeros_like(pooled), pooled], dim=1),
            torch.stack([ids6, ids6], dim=1))


def unet_pair(unet: UNet, noisy: torch.Tensor, t: int, text: tuple, d: int) -> torch.Tensor:
    """The CFG pair's noise predictions [2, 4, h, w] of the view bucket `d`."""
    ctx, pooled, ids = (x[d] for x in text)
    return unet(torch.cat([noisy] * 2), t, ctx, pooled, ids)

"""The model FLOPs of the SDXL edit step and the shape of its flash call,
counted by `opcount`'s rules (each multiply-add of a convolution, a linear
layer or an attention product twice, once; norms and elementwise work left
out), with what SDXL adds: the transformer depth of each level (and the
mid block's, the last level's), the text_time added embedding and the
configuration's context width."""
from __future__ import annotations

from typing import Tuple

from portbench.metrics.lib.opcount import TEXT_TOKENS, _resnet, attention, conv, latent_side, linear, render_flops
from portbench.metrics.lib.opcount import vae_encoder_flops


def _depth(u: dict, level: int) -> int:
    depth = u.get("transformer_layers_per_block", 1)
    return depth if isinstance(depth, int) else depth[level]


def _transformer(c: int, side: int, ctx: int, depth: int) -> float:
    n = side * side
    block = 4 * linear(c, c, n) + attention(n, n, c)  # self-attention
    block += 2 * linear(c, c, n) + 2 * linear(ctx, c, TEXT_TOKENS) + attention(n, TEXT_TOKENS, c)
    block += linear(c, 8 * c, n) + linear(4 * c, c, n)  # GEGLU feed-forward
    return 2 * linear(c, c, n) + depth * block  # proj_in, proj_out around the stack


def unet_flops(u: dict, latent: int) -> float:
    """One image through SDXL's UNet at `latent`^2."""
    chans, n, ctx = u["block_out_channels"], u["layers_per_block"], u["cross_attention_dim"]
    temb = 4 * chans[0]
    f = linear(chans[0], temb, 1) + linear(temb, temb, 1) + conv(u["in_channels"], chans[0], 3, latent)
    f += linear(u["projection_class_embeddings_input_dim"], temb, 1) + linear(temb, temb, 1)  # add_embedding
    side, cin, skips = latent, chans[0], [chans[0]]
    for level, ch in enumerate(chans):
        cross = u["down_block_types"][level] == "CrossAttnDownBlock2D"
        for _ in range(n):
            f += _resnet(cin, ch, side, temb) + (_transformer(ch, side, ctx, _depth(u, level)) if cross else 0.0)
            cin = ch
            skips.append(ch)
        if level != len(chans) - 1:
            side //= 2
            f += conv(ch, ch, 3, side)
            skips.append(ch)
    f += 2 * _resnet(cin, cin, side, temb) + _transformer(cin, side, ctx, _depth(u, len(chans) - 1))
    for up_idx in range(len(chans)):
        level = len(chans) - 1 - up_idx
        ch = chans[level]
        cross = u["up_block_types"][up_idx] == "CrossAttnUpBlock2D"
        for _ in range(n + 1):
            f += _resnet(cin + skips.pop(), ch, side, temb)
            f += _transformer(ch, side, ctx, _depth(u, level)) if cross else 0.0
            cin = ch
        if up_idx != len(chans) - 1:
            side *= 2
            f += conv(ch, ch, 3, side)
    return f + conv(cin, u["out_channels"], 3, side)


def edit_step_flops(cfg: dict) -> float:
    """The SDS edit step with SDXL: the render and its input gradient, the
    VAE encoder and its input gradient at SDXL's image size, the UNet on
    the CFG pair."""
    sd, res = cfg["sd"], cfg["grid"]["res"]
    return (2 * render_flops(res, cfg["edit"]["base_res"], 3) + 2 * vae_encoder_flops(sd["vae"], sd["image_size"])
            + 2 * unet_flops(sd["unet"], latent_side(sd)))


def flash_shape(sd: dict) -> Tuple[int, int, int, int]:
    """[batch, tokens, heads, head size] of the UNet's flash self-attention:
    the CFG pair at the first level with attention (its down block a
    cross-attention block), whose tokens are the most."""
    u = sd["unet"]
    level = next(i for i, kind in enumerate(u["down_block_types"]) if kind == "CrossAttnDownBlock2D")
    heads = u["attention_head_dim"][level]
    return 2, (latent_side(sd) >> level) ** 2, heads, u["block_out_channels"][level] // heads

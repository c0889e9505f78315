"""Frozen arithmetic of the per-layer metrics: the chip's published peaks,
the model FLOPs of a step counted from the configuration's shapes, and the
least time of a kernel call (its roofline).

FLOPs count each multiply-add of a convolution, a linear layer or an
attention product as two, once: the model's work, not what a path
recomputes. Norms, activations and other elementwise work are left out.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
TEXT_TOKENS = 77


def conv(cin: int, cout: int, k: int, side: int) -> float:
    """A k x k convolution with `side`^2 outputs, one image."""
    return 2.0 * cin * cout * k * k * side * side


def linear(cin: int, cout: int, tokens: int) -> float:
    return 2.0 * cin * cout * tokens


def attention(tokens_q: int, tokens_k: int, width: int) -> float:
    """q k^T and p v over all heads (width = heads x head size)."""
    return 4.0 * tokens_q * tokens_k * width


def _resnet(cin: int, cout: int, side: int, temb: int = 0) -> float:
    f = conv(cin, cout, 3, side) + conv(cout, cout, 3, side) + linear(temb, cout, 1)
    return f + (conv(cin, cout, 1, side) if cin != cout else 0.0)


def _transformer(c: int, side: int, ctx: int) -> float:
    n = side * side
    f = 2 * linear(c, c, n)  # proj_in, proj_out
    f += 4 * linear(c, c, n) + attention(n, n, c)  # self-attention
    f += 2 * linear(c, c, n) + 2 * linear(ctx, c, TEXT_TOKENS) + attention(n, TEXT_TOKENS, c)
    return f + linear(c, 8 * c, n) + linear(4 * c, c, n)  # GEGLU feed-forward


def unet_flops(u: dict, latent: int) -> float:
    """One image through the conditional UNet at `latent`^2."""
    chans, n = u["block_out_channels"], u["layers_per_block"]
    temb = 4 * chans[0]
    f = linear(chans[0], temb, 1) + linear(temb, temb, 1) + conv(u["in_channels"], chans[0], 3, latent)
    side, cin, skips = latent, chans[0], [chans[0]]
    for level, ch in enumerate(chans):
        cross = u["down_block_types"][level] == "CrossAttnDownBlock2D"
        for _ in range(n):
            f += _resnet(cin, ch, side, temb) + (_transformer(ch, side, u["cross_attention_dim"]) if cross else 0.0)
            cin = ch
            skips.append(ch)
        if level != len(chans) - 1:
            side //= 2
            f += conv(ch, ch, 3, side)
            skips.append(ch)
    f += 2 * _resnet(cin, cin, side, temb) + _transformer(cin, side, u["cross_attention_dim"])
    for up_idx in range(len(chans)):
        ch = chans[len(chans) - 1 - up_idx]
        cross = u["up_block_types"][up_idx] == "CrossAttnUpBlock2D"
        for _ in range(n + 1):
            f += _resnet(cin + skips.pop(), ch, side, temb)
            f += _transformer(ch, side, u["cross_attention_dim"]) if cross else 0.0
            cin = ch
        if up_idx != len(chans) - 1:
            side *= 2
            f += conv(ch, ch, 3, side)
    return f + conv(cin, u["out_channels"], 3, side)


def vae_encoder_flops(v: dict, image: int) -> float:
    """One image through the VAE encoder and the moments' 1x1 convolution."""
    chans, n = v["block_out_channels"], v["layers_per_block"]
    f = conv(v["in_channels"], chans[0], 3, image)
    side, cin = image, chans[0]
    for level, ch in enumerate(chans):
        for _ in range(n):
            f += _resnet(cin, ch, side)
            cin = ch
        if level != len(chans) - 1:
            side //= 2
            f += conv(ch, ch, 3, side)
    f += 2 * _resnet(cin, cin, side) + 4 * linear(cin, cin, side * side) + attention(side * side, side * side, cin)
    lat = 2 * v["latent_channels"]
    return f + conv(cin, lat, 3, side) + conv(lat, lat, 1, side)


def render_flops(res: int, base: int, channels: int) -> float:
    """The shear-warp resample of a res^3 table of `channels` + 1 values onto
    a base^2 lattice: the row contraction, then the column contraction."""
    c1 = channels + 1
    return 2.0 * res * base * res * res * c1 + 2.0 * res * base * base * res * c1


def latent_side(sd: dict) -> int:
    return sd["image_size"] // 2 ** (len(sd["vae"]["block_out_channels"]) - 1)


def edit_step_flops(cfg: dict) -> float:
    """The SDS edit step: the render and its input gradient, the VAE encoder
    and its input gradient at SD's image size, the UNet on the CFG pair."""
    sd, res = cfg["sd"], cfg["grid"]["res"]
    return (2 * render_flops(res, cfg["edit"]["base_res"], 3) + 2 * vae_encoder_flops(sd["vae"], sd["image_size"])
            + 2 * unet_flops(sd["unet"], latent_side(sd)))


def refine_step_flops(cfg: dict) -> float:
    """The refinement iteration: the RGB frame, the VAE encoder (no
    gradient), the capture UNet on the CFG pair, the two-channel attention
    render and its input gradient."""
    sd, res, base = cfg["sd"], cfg["grid"]["res"], cfg["refine"]["base_res"]
    return (render_flops(res, base, 3) + vae_encoder_flops(sd["vae"], sd["image_size"])
            + 2 * unet_flops(sd["unet"], latent_side(sd)) + 2 * render_flops(res, base, 2))


def flash_shape(sd: dict) -> Tuple[int, int, int, int]:
    """[batch, tokens, heads, head size] of the UNet's flash self-attention:
    the CFG pair at the first level (latent^2 tokens)."""
    u = sd["unet"]
    heads = u["attention_head_dim"][0]
    return 2, latent_side(sd) ** 2, heads, u["block_out_channels"][0] // heads


def flash_fwd_bound_s(shape) -> float:
    """max(FLOPs / peak, bytes / bandwidth) of one forward call: q k^T and
    p v, and Q, K, V, O in bfloat16 each read or written once."""
    b, n, h, d = shape
    flops = 4.0 * b * h * n * n * d
    nbytes = 4.0 * b * n * h * d * 2
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def composite_bytes(n: int, s: int) -> float:
    """The compositing kernel's traffic at [N, S] in float32: density and
    depth read and the weight written a sample, the direction norm read and
    the accumulated weight written a ray."""
    return 12.0 * n * s + 8.0 * n


def composite_bound_s(n: int, s: int) -> float:
    return composite_bytes(n, s) / PEAK_HBM_BYTES_PER_S


def recon_step_flops(cfg: dict) -> float:
    """The recon step: the resample onto the base lattice and its input
    gradient (the colour and diffuse composites share one resample)."""
    return 2 * render_flops(cfg["grid"]["res"], cfg["recon"]["base_res"], 3)

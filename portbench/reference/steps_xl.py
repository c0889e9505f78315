"""The plain reference of the SDXL edit step's first three steps, from the
same seed as the program's run, built from `portbench.reference.steps`'s
pieces (the pose draw, the resize and VAE encode, the readings) with SDXL's
towers and UNet (`portbench.reference.sdxl`).

Nothing here imports the program; the inputs come from `portbench.lib`.
"""
from __future__ import annotations

import torch

from portbench.lib import inputs
from portbench.lib.seeds import generator
from portbench.lib.weights import draw, materialize
from portbench.reference import sd, sdxl
from portbench.reference.precision import Rounding, precise
from portbench.reference.render import GridSpec, orient, render
from portbench.reference.steps import DTYPES, _readings, encode, hemisphere_draw
from portbench.reference.train import Adam, density_correlation_loss, staircase


def build_sdxl(cfg: dict, seed: int, device, q: Rounding):
    """(shapes, {"text_encoder", "text_encoder_2", "vae", "unet"} float32
    reference modules) with the run's seeded weights, one module at a time."""
    s = cfg["sd"]
    dtypes = s["dtypes"]
    mods = sdxl.build(s, {name: q.below(dtypes[name]) for name in sdxl.MODULES})
    for name, module in mods.items():
        materialize(module, draw(module, generator(seed, f"weights.{name}", device), DTYPES[dtypes[name]]), device)
    return sd.SDShapes.from_config(s), mods


@precise
def edit_xl(cfg: dict, cell: dict, seed: int, device, q: Rounding) -> dict:
    """The SDS edit step with SDXL as the prior: shear-warp frame, upright
    turn, resize to 1024^2 and VAE encode, the CFG UNet at t with the
    view's context, pooled row and time ids (zeros for the empty negative
    prompt), the SDS gradient into the latents, density correlation against
    the starting grid, Adam on densities and features."""
    shapes, mods = build_sdxl(cfg, seed, device, q)
    vae, unet = mods["vae"], mods["unet"]
    grid, edit_cfg = cfg["grid"], cfg["edit"]
    spec, rq = GridSpec.from_config(grid), q.below(grid["gather_dtype"])
    ids = inputs.token_ids(seed, shapes.text_encoder, edit_cfg["prompt_tokens"], device)[:, 1]
    text = sdxl.encode_text(mods, ids, cfg["sd"]["add_time_ids"])
    del mods["text_encoder"], mods["text_encoder_2"]
    dens = inputs.grid_values(seed, "densities", spec.res, 1, device).requires_grad_(True)
    feats = inputs.grid_values(seed, "features", spec.res, 3, device).requires_grad_(True)
    ref_d = dens.detach().clone()
    alphas = sd.alphas_cumprod(shapes.scheduler, device)
    base = (edit_cfg["base_res"],) * 2
    lo, hi = edit_cfg["t_range"]
    lat_shape = (1, shapes.vae["latent_channels"], shapes.latent_size, shapes.latent_size)
    gen = generator(seed, "draws", device)
    adam = Adam({"densities": dens, "features": feats},
                staircase(edit_cfg["lr"], edit_cfg["lr_freq"], edit_cfg["lr_gamma"], edit_cfg["lr_decay_start"]))

    def step():
        rot, trans, d = hemisphere_draw(gen, edit_cfg["radius"], device)
        t = int(torch.randint(lo, hi + 1, (), generator=gen, device=gen.device))
        eps = torch.randn(lat_shape, generator=gen, device=gen.device)
        noise = torch.randn(lat_shape, generator=gen, device=gen.device)
        frame = orient(render(dens, feats, spec, rot, trans, base, rq, 1.0).reshape(*base, 3), rot)
        lat = encode(vae, shapes, frame, eps)
        a = alphas[t]
        noisy = torch.sqrt(a) * lat.detach() + torch.sqrt(1.0 - a) * noise
        with torch.no_grad():
            uncond, cond = sdxl.unet_pair(unet, noisy, t, text, d).chunk(2)
        pred = cond + edit_cfg["guidance_scale"] * (cond - uncond)
        sds_grad = torch.nan_to_num((1.0 - a) * (pred - noise))
        dcl = density_correlation_loss(dens, ref_d) * edit_cfg["density_correlation_weight"]
        g_d, g_f = torch.autograd.grad((lat * sds_grad).sum() + dcl, [dens, feats])
        return float(dcl.detach()), {"densities": g_d, "features": g_f}

    return _readings({"densities": dens, "features": feats}, step, [adam])

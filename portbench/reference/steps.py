"""The plain reference of each entry's first three steps, from the same
seed as the program's run: the same weights, grid values, prompts, views
and draws (the draws replayed from the same generator in the program's
order of use). Each returns the readings the check compares: every step's
loss, each leaf's first gradient and each leaf's change over the three
steps.

Nothing here imports the program; the inputs come from `portbench.lib`.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from portbench.lib import inputs
from portbench.lib.seeds import generator, host_rng
from portbench.lib.weights import draw, materialize
from portbench.reference import sd
from portbench.reference.precision import Rounding, precise
from portbench.reference.render import GridSpec, direction_index, orient, pose_from_angles, render, warp_to_base
from portbench.reference.train import (
    Adam,
    density_correlation_loss,
    masked_attention_l1,
    select_targets,
    staircase,
    token_maps,
    tv_loss,
)

STEPS = 3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_sd(cfg: dict, seed: int, device, q: Rounding):
    """(shapes, {"text_encoder", "vae", "unet"} float32 reference modules)
    with the run's seeded weights."""
    shapes = sd.SDShapes.from_config(cfg["sd"])
    dtypes = cfg["sd"]["dtypes"]
    mods = sd.build(shapes, {name: q.below(dt) for name, dt in dtypes.items()})
    for name, module in mods.items():
        materialize(module, draw(module, generator(seed, f"weights.{name}", device), DTYPES[dtypes[name]]), device)
    return shapes, mods


@torch.no_grad()
def text_by_direction(text_encoder, ids: torch.Tensor) -> torch.Tensor:
    """[4, 2, T] ids -> [4, 2, T, D] embeddings."""
    return text_encoder(ids.reshape(-1, ids.shape[-1])).reshape(*ids.shape, -1)


def hemisphere_draw(gen: torch.Generator, radius: float, device):
    """The program's hemisphere pose draw: pitch ~ U[15, 90), yaw ~ U[0, 360)."""
    u = torch.rand(2, generator=gen, device=gen.device)
    pitch, yaw = (15.0 + u[0] * 75.0).to(device), (u[1] * 360.0).to(device)
    rot, trans = pose_from_angles(pitch, yaw, radius)
    return rot, trans, direction_index(float(pitch), float(yaw))


def encode(vae, shapes: sd.SDShapes, frame: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """An upright frame [H, W, 3] in [0, 1] -> latents, through the
    antialiased bilinear resize to SD's image size."""
    size = shapes.image_size
    x = F.interpolate(frame[None].permute(0, 3, 1, 2), size=(size, size), mode="bilinear", antialias=True,
                      align_corners=False)
    return vae.encode(2.0 * x - 1.0, eps)


def _readings(leaves: Dict[str, torch.Tensor], step: Callable, adam_list) -> dict:
    start = {k: v.detach().clone() for k, v in leaves.items()}
    losses, grad = [], {}
    for i in range(STEPS):
        loss, grads = step()
        losses.append(loss)
        if i == 0:
            grad = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
        for adam in adam_list:
            adam.step({k: grads[k] for k in adam.params})
    change = {k: float(torch.linalg.vector_norm((v.detach() - start[k]).double())) for k, v in leaves.items()}
    return {"loss": losses, "grad_norm": grad, "change_norm": change}


@precise
def edit(cfg: dict, cell: dict, seed: int, device, q: Rounding) -> dict:
    """The SDS edit step: shear-warp frame, upright turn, resize and VAE
    encode, the CFG UNet at t, the SDS gradient into the latents, density
    correlation against the starting grid, Adam on densities and features."""
    shapes, mods = build_sd(cfg, seed, device, q)
    vae, unet = mods["vae"], mods["unet"]
    grid, edit_cfg = cfg["grid"], cfg["edit"]
    spec, rq = GridSpec.from_config(grid), q.below(grid["gather_dtype"])
    text = text_by_direction(mods["text_encoder"], inputs.token_ids(seed, shapes.text_encoder,
                                                                     edit_cfg["prompt_tokens"], device))
    del mods["text_encoder"]
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
            uncond, cond = unet(torch.cat([noisy] * 2), t, text[d]).chunk(2)
        pred = cond + edit_cfg["guidance_scale"] * (cond - uncond)
        sds_grad = torch.nan_to_num((1.0 - a) * (pred - noise))
        dcl = density_correlation_loss(dens, ref_d) * edit_cfg["density_correlation_weight"]
        g_d, g_f = torch.autograd.grad((lat * sds_grad).sum() + dcl, [dens, feats])
        return float(dcl.detach()), {"densities": g_d, "features": g_f}

    return _readings({"densities": dens, "features": feats}, step, [adam])


@precise
def refine(cfg: dict, cell: dict, seed: int, device, q: Rounding) -> dict:
    """The refinement iteration: the no-grad RGB frame, VAE encode and the
    capture UNet at the fixed t, the token maps at the frame's size, the
    edit and object targets, the two-channel attention render, masked L1
    plus TV on each channel, an Adam step for each grid."""
    shapes, mods = build_sd(cfg, seed, device, q)
    vae, unet = mods["vae"], mods["unet"]
    grid, rcfg = cfg["grid"], cfg["refine"]
    spec, rq = GridSpec.from_config(grid), q.below(grid["gather_dtype"])
    n_tok = rcfg["prompt_tokens"]
    text = text_by_direction(mods["text_encoder"], inputs.token_ids(seed, shapes.text_encoder, n_tok, device))
    del mods["text_encoder"]
    idxs, emask, omask = inputs.token_selection(n_tok, rcfg["edit_tokens"], device)
    dens = inputs.grid_values(seed, "densities", spec.res, 1, device)
    feats = inputs.grid_values(seed, "features", spec.res, 3, device)
    attn_e = inputs.grid_values(seed, "attn_edit", spec.res, 1, device).requires_grad_(True)
    attn_o = inputs.grid_values(seed, "attn_object", spec.res, 1, device).requires_grad_(True)
    alphas = sd.alphas_cumprod(shapes.scheduler, device)
    base = (rcfg["base_res"],) * 2
    t = int(rcfg["timestep"])
    lat_shape = (1, shapes.vae["latent_channels"], shapes.latent_size, shapes.latent_size)
    gen = generator(seed, "draws", device)
    lr = staircase(rcfg["lr"], rcfg["lr_decay_steps"], rcfg["lr_decay_gamma"])
    adams = [Adam({"attn_edit": attn_e}, lr), Adam({"attn_object": attn_o}, lr)]
    tv_w = rcfg["attn_tv_weight"]

    def step():
        rot, trans, d = hemisphere_draw(gen, rcfg["radius"], device)
        with torch.no_grad():
            frame = orient(render(dens, feats, spec, rot, trans, base, rq, 1.0).reshape(*base, 3), rot)
            eps = torch.randn(lat_shape, generator=gen, device=gen.device)
            noise = torch.randn(lat_shape, generator=gen, device=gen.device)
            lat = encode(vae, shapes, frame, eps)
            noisy = torch.sqrt(alphas[t]) * lat + torch.sqrt(1.0 - alphas[t]) * noise
            store = []
            unet(torch.cat([noisy] * 2), t, text[d], store)
            edit_map, obj_map = select_targets(token_maps(store, idxs, base[0]), emask, omask)
        out = render(dens, torch.cat([attn_e, attn_o], dim=-1), spec, rot, trans, base, rq, 0.0)
        rendered = orient(out.reshape(*base, 2), rot)
        loss_e = masked_attention_l1(rendered[..., 0], edit_map) + tv_loss(attn_e) * tv_w
        loss_o = masked_attention_l1(rendered[..., 1], obj_map) + tv_loss(attn_o) * tv_w
        g_e, g_o = torch.autograd.grad(loss_e + loss_o, [attn_e, attn_o])
        return (float(loss_e.detach()), float(loss_o.detach())), {"attn_edit": g_e, "attn_object": g_o}

    return _readings({"attn_edit": attn_e, "attn_object": attn_o}, step, adams)


@precise
def recon(cfg: dict, cell: dict, seed: int, device, q: Rounding) -> dict:
    """The recon step on the shear-warp path: one training view a step, its
    base-plane frame (colour and diffuse composites) against the view's
    pre-warped target, masked L1 over the covered pixels, Adam on densities
    and features."""
    grid, rc = cfg["grid"], cfg["recon"]
    spec, rq = GridSpec.from_config(grid), q.below(grid["gather_dtype"])
    dens = inputs.grid_values(seed, "densities", spec.res, 1, device).requires_grad_(True)
    feats = inputs.grid_values(seed, "features", spec.res, 3, device).requires_grad_(True)
    images, poses = inputs.training_views(seed, cfg["views"], device)
    base = (rc["base_res"],) * 2
    focal = float(cfg["views"]["focal"])
    warped = [warp_to_base(images[i], poses[i][:, :3], poses[i][:, 3:], focal, spec, base) for i in range(len(poses))]
    del images
    order = host_rng(seed, "view_order")
    adam = Adam({"densities": dens, "features": feats}, staircase(rc["lr"], rc["lr_decay_steps"], rc["lr_decay_gamma"]))

    def step():
        idx = int(order.integers(0, len(poses)))
        target, mask = warped[idx]
        rot = torch.as_tensor(poses[idx][:, :3], device=device)
        trans = torch.as_tensor(poses[idx][:, 3:], device=device)
        img = render(dens, feats, spec, rot, trans, base, rq, 1.0).reshape(*base, 3)
        denom = torch.clamp(mask.sum() * 3.0, min=1.0)
        l1 = ((img - target).abs() * mask[..., None]).sum() / denom
        total = l1 + l1  # the colour and the diffuse composite coincide at SH degree 0
        g_d, g_f = torch.autograd.grad(total, [dens, feats])
        return float(total.detach()), {"densities": g_d, "features": g_f}

    return _readings({"densities": dens, "features": feats}, step, [adam])

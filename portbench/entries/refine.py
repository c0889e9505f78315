"""Entry `refine`: the program's attention-grid refinement iteration, one a
call, as the refine CLI runs it (`train/refine.py::make_refine_multi_step`
on the shear-warp path): a hemisphere pose and its prompt, the no-grad RGB
frame, VAE encode and the capture UNet at the fixed t, the token maps and
`select_targets`, the two-channel attention render forward and backward
over the frozen densities, and an Adam update of each attention grid."""
from __future__ import annotations

import contextlib

import torch

from portbench.lib import inputs, program
from portbench.lib.check import program_readings
from portbench.lib.faults import patched
from portbench.lib.seeds import generator
from portbench.lib.session import Session
from portbench.reference import steps as reference_steps
from portbench.reference.render import GridSpec

reference = reference_steps.refine


def setup(cfg: dict, cell: dict, seed: int, device) -> Session:
    from voxe_tpu_torch.grid.voxels import VoxelGrid
    from voxe_tpu_torch.train import refine as train_refine
    from voxe_tpu_torch.train.recon import exponential_decay_staircase

    r = cfg["refine"]
    spec = GridSpec.from_config(cfg["grid"])
    model = program.build_sd(cfg, seed, device)
    n_tok = r["prompt_tokens"]
    ids = inputs.token_ids(seed, cfg["sd"]["text_encoder"], n_tok, device)
    with torch.no_grad():
        text_by_dir = torch.stack([model.clip(ids[d]) for d in range(inputs.DIRECTIONS)])
    selection = [inputs.token_selection(n_tok, r["edit_tokens"], device)] * inputs.DIRECTIONS
    base_grid = VoxelGrid(
        densities=inputs.grid_values(seed, "densities", spec.res, 1, device),
        features=inputs.grid_values(seed, "features", spec.res, 3, device),
        config=program.grid_config(cfg["grid"]),
    )
    edit_attn = inputs.grid_values(seed, "attn_edit", spec.res, 1, device)
    obj_attn = inputs.grid_values(seed, "attn_object", spec.res, 1, device)
    opt_e = train_refine.make_attn_adam(edit_attn, r["lr"])
    opt_o = train_refine.make_attn_adam(obj_attn, r["lr"])
    base = r["base_res"]
    multi = train_refine.make_refine_multi_step(
        model, program.render_config(r), opt_e, opt_o, base_grid, (base, base), r["timestep"],
        r["attn_tv_weight"], 1, r["radius"],
        lr_schedule=exponential_decay_staircase(r["lr"], r["lr_decay_steps"], r["lr_decay_gamma"]),
    )
    gen = generator(seed, "draws", device)
    leaves = {"attn_edit": edit_attn, "attn_object": obj_attn}
    opts = {"attn_edit": opt_e, "attn_object": opt_o}

    def step():
        return multi(edit_attn, obj_attn, text_by_dir, selection, gen)

    def losses():
        m = step()
        return float(m["total_loss_edit"]), float(m["total_loss_object"])

    readings = program_readings(losses, leaves, lambda k: opts[k].state.get(leaves[k], {})["exp_avg"])
    return Session(step, readings, leaves)


@contextlib.contextmanager
def half_batch():
    """The attention loss over the first half of the attention render's
    pixel rows, the mean taken over those."""
    from voxe_tpu_torch.train import refine

    orig = refine.calc_loss_on_attn_grid

    def calc_loss(attn_render, attn_map):
        rows = attn_render.shape[0] // 2
        return orig(attn_render[:rows], attn_map[:rows])

    with patched(refine, "calc_loss_on_attn_grid", calc_loss):
        yield


FAULTS = {"half": half_batch}

"""Entry `edit`: the program's SDS edit step in random-pose mode, one step a
call, as the edit CLI runs it (`train/sds.py::make_sds_train_multi_step` on
the shear-warp path): each call draws a hemisphere pose, buckets its view
direction to pick the prompt, draws t in the schedule's starting bounds,
renders the base-plane frame, encodes it with the VAE, runs the CFG UNet,
injects the SDS gradient, adds density correlation against the starting
grid, runs the backward and one Adam update of the grid."""
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

reference = reference_steps.edit


def setup(cfg: dict, cell: dict, seed: int, device) -> Session:
    from voxe_tpu_torch.grid.voxels import VoxelGrid
    from voxe_tpu_torch.train import sds as train_sds
    from voxe_tpu_torch.train.recon import exponential_decay_staircase, make_adam
    from voxe_tpu_torch.utils.camera import CameraIntrinsics

    e = cfg["edit"]
    spec = GridSpec.from_config(cfg["grid"])
    model = program.build_sd(cfg, seed, device)
    ids = inputs.token_ids(seed, cfg["sd"]["text_encoder"], e["prompt_tokens"], device)
    with torch.no_grad():
        text_by_dir = torch.stack([model.clip(ids[d]) for d in range(inputs.DIRECTIONS)])
    grid = VoxelGrid(
        densities=inputs.grid_values(seed, "densities", spec.res, 1, device),
        features=inputs.grid_values(seed, "features", spec.res, 3, device),
        config=program.grid_config(cfg["grid"]),
    )
    ref_d, ref_f = grid.densities.clone(), grid.features.clone()
    opt = make_adam(grid, e["lr"])
    base = e["base_res"]
    multi = train_sds.make_sds_train_multi_step(
        model, program.render_config(e), opt, CameraIntrinsics(base, base, float(base)), 1,
        radius=e["radius"], use_shear_warp=True, sw_base_hw=(base, base),
        lr_schedule=exponential_decay_staircase(e["lr"], e["lr_freq"], e["lr_gamma"],
                                                transition_begin=e["lr_decay_start"]),
        density_correlation_weight=e["density_correlation_weight"], guidance_scale=e["guidance_scale"],
    )
    t_bounds = torch.tensor([e["t_range"]])
    gen = generator(seed, "draws", device)
    leaves = {"densities": grid.densities, "features": grid.features}

    def step():
        return multi(grid, text_by_dir, ref_d, ref_f, t_bounds, gen)

    readings = program_readings(lambda: float(step()["total_loss"]), leaves,
                                lambda k: opt.state.get(leaves[k], {})["exp_avg"])
    return Session(step, readings, leaves)


@contextlib.contextmanager
def half_batch():
    """The SDS gradient on the first half of the latent rows, doubled (the
    mean over those rows), nought on the rest."""
    from voxe_tpu_torch.models.sd import sds

    orig = sds.specify_gradient

    def specify_gradient(latents, grad):
        keep = torch.zeros_like(grad)
        keep[:, :, : grad.shape[2] // 2] = 2.0
        return orig(latents, grad * keep)

    with patched(sds, "specify_gradient", specify_gradient):
        yield


@contextlib.contextmanager
def sds_weight_half():
    """The SDS gradient at half its size: every value changed, none
    zeroed, its direction kept."""
    from voxe_tpu_torch.models.sd import sds

    orig = sds.specify_gradient
    with patched(sds, "specify_gradient", lambda latents, grad: orig(latents, 0.5 * grad)):
        yield


@contextlib.contextmanager
def guidance_half():
    """Classifier-free guidance at half the configuration's scale."""
    from voxe_tpu_torch.train import sds as train_sds

    orig = train_sds.sds_edit_loss

    def sds_edit_loss(*args, guidance_scale=100.0, **kwargs):
        return orig(*args, guidance_scale=0.5 * guidance_scale, **kwargs)

    with patched(train_sds, "sds_edit_loss", sds_edit_loss):
        yield


FAULTS = {"half": half_batch, "sds_weight_half": sds_weight_half, "guidance_half": guidance_half}

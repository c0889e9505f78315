"""Entry `recon`: the program's shear-warp reconstruction step, one a call,
as the recon CLI's final stage runs it
(`train/recon.py::make_recon_train_multi_step_shearwarp`): one training
view a step, drawn from the seed on the host, its base-plane frame (colour
and diffuse composites, the compositing kernel where the stage's checkpoint
says so) against the view's pre-warped target, masked L1, the backward and
one Adam update on the stage's staircase learning rate."""
from __future__ import annotations

import contextlib

import torch

from portbench.lib import inputs, program
from portbench.lib.check import program_readings
from portbench.lib.faults import patched
from portbench.lib.seeds import host_rng
from portbench.lib.session import Session
from portbench.reference import steps as reference_steps
from portbench.reference.render import GridSpec

reference = reference_steps.recon


def setup(cfg: dict, cell: dict, seed: int, device) -> Session:
    from voxe_tpu_torch.grid.voxels import VoxelGrid
    from voxe_tpu_torch.train import recon as train_recon
    from voxe_tpu_torch.utils.camera import CameraIntrinsics

    rc, views = cfg["recon"], cfg["views"]
    spec = GridSpec.from_config(cfg["grid"])
    grid = VoxelGrid(
        densities=inputs.grid_values(seed, "densities", spec.res, 1, device),
        features=inputs.grid_values(seed, "features", spec.res, 3, device),
        config=program.grid_config(cfg["grid"]),
    )
    images, poses = inputs.training_views(seed, views, device)
    poses_t = torch.as_tensor(poses, device=device)
    size, base = int(views["image_size"]), (rc["base_res"],) * 2
    intrinsics = CameraIntrinsics(size, size, float(views["focal"]))
    targets, masks = train_recon.warp_dataset_to_base(images, poses_t, intrinsics, grid, base)
    del images
    opt = train_recon.make_adam(grid, rc["lr"])
    multi = train_recon.make_recon_train_multi_step_shearwarp(
        program.render_config(rc), opt, base, 1, True,
        lr_schedule=train_recon.exponential_decay_staircase(rc["lr"], rc["lr_decay_steps"], rc["lr_decay_gamma"]),
    )
    order = host_rng(seed, "view_order")
    leaves = {"densities": grid.densities, "features": grid.features}

    def step():
        return multi(grid, targets, masks, poses_t, [int(order.integers(0, len(poses)))])

    readings = program_readings(lambda: float(step()["total_loss"]), leaves,
                                lambda k: opt.state.get(leaves[k], {})["exp_avg"])
    return Session(step, readings, leaves, units_per_step=base[0] * base[1])


@contextlib.contextmanager
def half_batch():
    """The masked L1 over the first half of the frame's pixel rows, the
    mean taken over those."""
    from voxe_tpu_torch.train import recon

    orig = recon.photometric_losses

    def photometric_losses(colour, diffuse, target, apply_diffuse, mask=None, denom=None):
        keep = torch.zeros_like(mask)
        keep[: mask.shape[0] // 2] = 1.0
        half = mask * keep
        return orig(colour, diffuse, target, apply_diffuse, mask=half,
                    denom=torch.clamp(half.sum() * colour.shape[-1], min=1.0))

    with patched(recon, "photometric_losses", photometric_losses):
        yield


FAULTS = {"half": half_batch}

"""Attention-grid refinement (counterpart of voxe_tpu/train/refine.py): learn
an edit and an object attention grid against Stable Diffusion's
cross-attention maps, graph-cut them into an edit region, and merge the
edited voxels into the reference model.

One iteration on the shear-warp path (`make_refine_iter_shearwarp`):
- a no-grad RGB frame of the edited grid on the base lattice (density noise
  forced to 0), oriented upright;
- a bilinear resize to SD's image size, VAE encode, `add_noise` at t and
  the capture UNet on the CFG batch; the token maps at the frame's size;
- the edit target, the max of the edit tokens' maps, and the object target,
  the max of the other tokens' maps (zero when there are none);
- one two-channel attention render of both grids over the frozen densities
  (`make_dual_attn_update`), masked L1 against the targets plus TV, and an
  Adam step for each grid on the staircase learning rate.
`make_attn_train_step` is the same update on the exact renderer, one render
per grid. `make_refine_multi_step` runs K shear-warp iterations a call (the
JAX package's `steps_per_call`): each draws a hemisphere pose, buckets its
view direction and takes that direction's text and token selection.
`refine_edited_relu_field` is the loop: hemisphere or dataset poses, one
iteration or (random poses on the shear-warp path) K a call, feedback,
`model_{edit,object}_iter_<n>.pth` snapshots, then the graph cut, the merge
and the final checkpoints.

There is no jit: the JAX package's single-dispatch iteration is a Python
function here; its `jax.random` draws (t, the VAE's eps, the noise, the
exact path's jitter) come from a `torch.Generator` or are passed in. The
token positions need no padded bucket: the maps are the same.

Every step builder takes a `mesh` (voxe_tpu_torch.parallel), as the JAX one
does: each rank renders its share of the base rows (or rays), the renders
are gathered (`gather_axis`) so that the masked losses divide by the whole
frame's mask, the TV terms count on rank 0 only, and one all-reduce sums
both grids' gradients and the metrics before the two Adam updates.
"""
from __future__ import annotations

import time
from datetime import timedelta
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.grid.voxels import VoxelGrid
from voxe_tpu_torch.models.sd.sds import DIRECTION_PROMPTS, StableDiffusion
from voxe_tpu_torch.models.sd.tokenizer import HashTokenizer
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.parallel.distributed import is_local_writer
from voxe_tpu_torch.parallel.mesh import all_reduce_grads, gather_axis, maybe_mesh, params_of, replicate
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig, render_sh_voxel_grid_attn
from voxe_tpu_torch.render.rays import cast_rays, flatten_rays
from voxe_tpu_torch.render.shearwarp import (
    check_shear_warp_hemisphere,
    check_shear_warp_poses,
    lane_aligned_res,
    orient_base_image,
    render_shear_warp,
)
from voxe_tpu_torch.seg.graphcut import get_edit_region, merge_edit_region
from voxe_tpu_torch.train.losses import tv_loss_on_grid
from voxe_tpu_torch.train.recon import apply_lr_schedule, exponential_decay_staircase
from voxe_tpu_torch.train.sds import (
    HEMISPHERICAL_RADIUS_CONSTANT,
    _sync,
    get_dir_batch_from_poses,
    render_rays_sharded,
    replicated_share,
)
from voxe_tpu_torch.utils import tracing
from voxe_tpu_torch.utils.camera import CameraPose, direction_index, get_random_pose, random_pose
from voxe_tpu_torch.utils.constants import CAMERA_BOUNDS, CAMERA_INTRINSICS, HEMISPHERICAL_RADIUS
from voxe_tpu_torch.utils.logging import log


def calc_loss_on_attn_grid(attn_render: torch.Tensor, attn_map: torch.Tensor) -> torch.Tensor:
    """Masked L1 between a rendered attention channel and its 2D target:
    only pixels where the render is positive (density present) count."""
    attn_render, attn_map = attn_render.reshape(-1), attn_map.reshape(-1)
    mask = (attn_render > 0.0).to(attn_map.dtype)
    return torch.sum(torch.abs(attn_render - attn_map) * mask) / (torch.sum(mask) + 1e-8)


def make_attn_adam(attn: torch.Tensor, lr: float) -> torch.optim.Adam:
    """Adam over one attention grid with optax.adam's defaults (b1 0.9,
    b2 0.999, eps 1e-8 outside the square root)."""
    attn.requires_grad_(True)
    return torch.optim.Adam([attn], lr=lr, betas=(0.9, 0.999), eps=1e-8)


@tracing.traced("optim")
def _step_adams(optimizers, lr_schedule, metrics: dict, mesh=None) -> dict:
    """One update of each optimizer at the schedule's lr; returns the
    detached metrics. With `mesh` one all-reduce first sums both grids'
    gradients and the metrics (replicated values, which rank 0 reports)."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is not None:
        share = replicated_share(mesh)
        metrics = all_reduce_grads(mesh, params_of(optimizers), {k: v * share for k, v in metrics.items()})
    for opt in optimizers:
        apply_lr_schedule(opt, lr_schedule)
        opt.step()
    return metrics


def make_dual_attn_update(
    render_config: SHVoxGridRenderConfig,
    optimizer_edit: torch.optim.Optimizer,
    optimizer_object: torch.optim.Optimizer,
    base_grid: VoxelGrid,
    sw_hw: tuple,
    attn_tv_weight: float,
    lr_schedule=None,
    mesh=None,
) -> Callable:
    """The dual attention-grid update given the 2D targets: both grids ride
    one two-channel attention render of the frozen density field on the
    shear-warp path (background 0), masked L1 + TV per channel, one Adam
    step each. With `mesh` each rank renders its base rows.

    signature: update(edit_attn, obj_attn, rotation [3,3], translation [3,1],
                      edit_map [U,V], obj_map [U,V], generator=None) -> metrics
    `edit_attn` / `obj_attn` ([X,Y,Z,1], the optimizers' tensors) are
    updated in place; `generator` draws the density noise when the config
    asks for it."""
    sw_hw = tuple(sw_hw)

    def update(edit_attn, obj_attn, rotation, translation, edit_map, obj_map, generator=None):
        optimizer_edit.zero_grad(set_to_none=True)
        optimizer_object.zero_grad(set_to_none=True)
        attn2 = torch.cat([edit_attn, obj_attn], dim=-1)
        out, _ = render_shear_warp(
            base_grid.replace(attn=attn2), CameraPose(rotation, translation.reshape(3, 1)), render_config,
            base_hw=sw_hw, attn_mode=True, background_value=0.0, generator=generator, mesh=mesh,
        )
        colour = out.colour.reshape(-1, sw_hw[1], 2)
        if mesh is not None:
            colour = gather_axis(mesh, colour, 0, sw_hw[0])
        rendered = orient_base_image(colour, rotation)
        with tracing.span("loss"):
            attn_l_e = calc_loss_on_attn_grid(rendered[..., 0], edit_map.detach())
            attn_l_o = calc_loss_on_attn_grid(rendered[..., 1], obj_map.detach())
            tv_e, tv_o = tv_loss_on_grid(edit_attn), tv_loss_on_grid(obj_attn)
            tv_weight = attn_tv_weight * replicated_share(mesh)  # TV on the replicated grids: counted once
            loss_e = attn_l_e + tv_e * tv_weight
            loss_o = attn_l_o + tv_o * tv_weight
        with tracing.span("backward"):
            (loss_e + loss_o).backward()  # the channels' losses are independent
        metrics = dict(
            attn_loss_edit=attn_l_e, tv_loss_edit=tv_e, total_loss_edit=attn_l_e + tv_e * attn_tv_weight,
            attn_loss_object=attn_l_o, tv_loss_object=tv_o, total_loss_object=attn_l_o + tv_o * attn_tv_weight,
        )
        return _step_adams((optimizer_edit, optimizer_object), lr_schedule, metrics, mesh)

    return update


def select_targets(maps: torch.Tensor, edit_mask: torch.Tensor, obj_mask: torch.Tensor):
    """(edit target, object target) from per-token maps [B, U, V]: the max
    over the maps each 0/1 mask [B] selects; a zero object target when the
    object mask selects none."""
    neg = torch.full((), -1e9, dtype=maps.dtype, device=maps.device)
    edit_map = torch.where(edit_mask[:, None, None] > 0, maps, neg).amax(dim=0)
    obj_map = torch.where(obj_mask[:, None, None] > 0, maps, neg).amax(dim=0)
    if not bool(tracing.scalar(obj_mask.sum() > 0, "targets.object")):
        obj_map = torch.zeros_like(obj_map)
    return edit_map, obj_map


def make_refine_iter_shearwarp(
    sd: StableDiffusion,
    render_config: SHVoxGridRenderConfig,
    optimizer_edit: torch.optim.Optimizer,
    optimizer_object: torch.optim.Optimizer,
    base_grid: VoxelGrid,
    sw_hw: tuple,
    timestamp: int,
    attn_tv_weight: float,
    lr_schedule=None,
    mesh=None,
) -> Callable:
    """One whole refinement iteration on the shear-warp path (with `mesh`,
    each rank renders its base rows of the frame and of the attention
    render; SD runs replicated on the gathered frame).

    signature: iter(edit_attn, obj_attn, text_embeddings [2,77,D],
                    rotation [3,3], translation [3,1], token_indices [B],
                    edit_mask [B], obj_mask [B], *, generator=None, t=None,
                    noise=None, vae_eps=None) -> metrics
    t is `timestamp`, or with `timestamp <= 0` a draw from the schedule
    (`t` replays one); `noise` / `vae_eps` ([1, h, w, 4]) replay the SD
    draws, otherwise they come from `generator`."""
    sw_hw = tuple(sw_hw)
    frame_config = render_config.replace(stochastic_density_noise_std=0.0)
    dual_update = make_dual_attn_update(
        render_config, optimizer_edit, optimizer_object, base_grid, sw_hw, attn_tv_weight, lr_schedule, mesh
    )

    def refine_iter(
        edit_attn, obj_attn, text_embeddings, rotation, translation, token_indices, edit_mask, obj_mask,
        *, generator=None, t=None, noise=None, vae_eps=None,
    ):
        if timestamp > 0:
            t = timestamp
        elif t is None:
            t = sd.sample_timestep(generator)
        with torch.no_grad():
            out, _ = render_shear_warp(
                base_grid.replace(attn=edit_attn.detach()), CameraPose(rotation, translation.reshape(3, 1)),
                frame_config, base_hw=sw_hw, mesh=mesh,
            )
            frame = out.colour.reshape(-1, sw_hw[1], 3)
            if mesh is not None:
                frame = gather_axis(mesh, frame, 0, sw_hw[0])
            pred_rgb = orient_base_image(frame, rotation)[None]
        maps = sd.attention_maps(
            text_embeddings, pred_rgb, t, token_indices, generator=generator, noise=noise, vae_eps=vae_eps
        )
        dev = maps.device
        edit_map, obj_map = select_targets(
            maps, torch.as_tensor(edit_mask, device=dev), torch.as_tensor(obj_mask, device=dev)
        )
        metrics = dual_update(edit_attn, obj_attn, rotation, translation, edit_map, obj_map, generator)
        metrics["t"] = int(t)
        return metrics

    return refine_iter


def make_refine_multi_step(
    sd: StableDiffusion,
    render_config: SHVoxGridRenderConfig,
    optimizer_edit: torch.optim.Optimizer,
    optimizer_object: torch.optim.Optimizer,
    base_grid: VoxelGrid,
    sw_hw: tuple,
    timestamp: int,
    attn_tv_weight: float,
    steps_per_call: int,
    radius: float,
    lr_schedule=None,
    mesh=None,
) -> Callable:
    """K refinement iterations a call (random-pose mode, shear-warp path):
    each draws a hemisphere pose, buckets its view direction (side,
    overhead, back, front = 0..3) and runs `make_refine_iter_shearwarp` with
    that direction's text embeddings and token selection (with `mesh`,
    every rank the same draws).

    signature: multi(edit_attn, obj_attn, text_by_dir [4, 2, 77, D],
                     selection_by_dir (4 of (token_indices, edit_mask,
                     obj_mask)), generator=None, *, poses=None, t=None,
                     noise=None, vae_eps=None) -> last iteration's metrics
    `poses` (rotation [K,3,3], translation [K,3,1], pitch_deg [K], yaw_deg
    [K]), `t` [K] and `noise` / `vae_eps` [K, 1, h, w, 4] replace the
    draws."""
    refine_iter = make_refine_iter_shearwarp(
        sd, render_config, optimizer_edit, optimizer_object, base_grid, sw_hw, timestamp, attn_tv_weight,
        lr_schedule, mesh,
    )

    def multi(edit_attn, obj_attn, text_by_dir, selection_by_dir, generator=None, *,
              poses=None, t=None, noise=None, vae_eps=None):
        dev = edit_attn.device
        metrics = {}
        for i in range(steps_per_call):
            with tracing.span("step"):
                with tracing.span("draw"):
                    if poses is None:
                        rotation, translation, pitch_deg, yaw_deg = random_pose(generator, radius, device=dev)
                    else:
                        rotation, translation, pitch_deg, yaw_deg = (
                            torch.as_tensor(x[i], dtype=torch.float32, device=dev) for x in poses)
                    dir_idx = direction_index(float(tracing.scalar(pitch_deg, "draw.pitch")),
                                              float(tracing.scalar(yaw_deg, "draw.yaw")))
                idxs, emask, omask = selection_by_dir[dir_idx]
                metrics = refine_iter(
                    edit_attn, obj_attn, text_by_dir[dir_idx], rotation, translation.reshape(3, 1), idxs, emask,
                    omask, generator=generator, t=None if t is None else int(t[i]),
                    noise=None if noise is None else noise[i], vae_eps=None if vae_eps is None else vae_eps[i],
                )
                metrics["dir_idx"] = dir_idx
        return metrics

    return multi


def make_attn_train_step(
    render_config: SHVoxGridRenderConfig,
    optimizer_edit: torch.optim.Optimizer,
    optimizer_object: torch.optim.Optimizer,
    base_grid: VoxelGrid,
    attn_tv_weight: float,
    lr_schedule=None,
    mesh=None,
) -> Callable:
    """The dual update on the exact renderer: each grid's attention render
    along the flat rays (jittered as the config says), masked L1 + TV, one
    Adam step each. With `mesh` each rank renders its share of the rays.

    signature: step(edit_attn, obj_attn, rays, edit_map [H,W], obj_map [H,W],
                    *, generator=None, t_rand_edit=None, t_rand_object=None)
               -> metrics
    `t_rand_*` ([R, S]) replace the jitter drawn from `generator`."""

    tv_weight = attn_tv_weight * replicated_share(mesh)  # TV on the replicated grids: counted once

    def grid_loss(attn, rays, target, generator, t_rand):
        colour = render_rays_sharded(
            render_sh_voxel_grid_attn, base_grid.replace(attn=attn), rays, render_config, generator, mesh, t_rand
        )
        attn_loss = calc_loss_on_attn_grid(colour[..., 0], target.detach())
        tv = tv_loss_on_grid(attn)
        return attn_loss + tv * tv_weight, attn_loss, tv

    def step(edit_attn, obj_attn, rays, edit_map, obj_map, *, generator=None, t_rand_edit=None, t_rand_object=None):
        optimizer_edit.zero_grad(set_to_none=True)
        optimizer_object.zero_grad(set_to_none=True)
        loss_e, attn_l_e, tv_e = grid_loss(edit_attn, rays, edit_map, generator, t_rand_edit)
        loss_o, attn_l_o, tv_o = grid_loss(obj_attn, rays, obj_map, generator, t_rand_object)
        with tracing.span("backward"):
            (loss_e + loss_o).backward()
        metrics = dict(
            attn_loss_edit=attn_l_e, tv_loss_edit=tv_e, total_loss_edit=attn_l_e + tv_e * attn_tv_weight,
            attn_loss_object=attn_l_o, tv_loss_object=tv_o, total_loss_object=attn_l_o + tv_o * attn_tv_weight,
        )
        return _step_adams((optimizer_edit, optimizer_object), lr_schedule, metrics, mesh)

    return step


def token_selection(num_tokens: int, edit_idx: Sequence[int], object_idx: Optional[int]):
    """(token positions 1..n, edit mask, object mask) of a prompt with n
    tokens: the edit mask marks `edit_idx`; the object mask marks
    `object_idx`, or every other token when it is None."""
    idxs = list(range(1, num_tokens + 1))
    emask = np.array([1.0 if i in edit_idx else 0.0 for i in idxs], np.float32)
    omask = np.zeros(num_tokens, np.float32)
    if object_idx is not None:
        if object_idx <= num_tokens:
            omask[object_idx - 1] = 1.0
    else:
        omask = 1.0 - emask
    return idxs, torch.from_numpy(emask), torch.from_numpy(omask)


def refine_edited_relu_field(
    vol_mod_edit: VolumetricModel,
    vol_mod_object: VolumetricModel,
    vol_mod_output: VolumetricModel,
    vol_mod_ref: VolumetricModel,
    train_dataset: PosedImagesDataset,
    output_dir: Path,
    prompt: str,
    edit_idx,
    timestamp: int,
    image_dims: tuple,
    *,
    hf_auth_token: str = "",
    object_idx: Optional[int] = None,
    num_iterations: int = 2000,
    ray_batch_size: int = 32768,
    scale_factor: float = 2.0,
    learning_rate: float = 0.03,
    lr_decay_gamma_per_stage: float = 0.1,
    lr_decay_steps_per_stage: int = 2000,
    render_feedback_pose: Optional[CameraPose] = None,
    data_pose_mode: bool = False,
    save_freq: int = 1000,
    feedback_freq: int = 100,
    summary_freq: int = 10,
    apply_diffuse_render_regularization: bool = False,
    verbose_rendering: bool = True,
    attn_tv_weight: float = 0.001,
    kval: float = 5.0,
    edit_mask_thresh: float = 0.992,
    num_obj_voxels_thresh: int = 5000,
    min_num_edit_voxels: int = 300,
    top_k_edit_thresh: int = 300,
    top_k_obj_thresh: int = 200,
    downsample_refine_grid: bool = False,
    sd_model: Optional[StableDiffusion] = None,
    sd_weights_dir: Optional[Path] = None,
    sd_config=None,
    sd_version: str = "1.4",
    seed: int = 42,
    fast_debug_mode: bool = False,
    num_devices: int = 1,
    use_shear_warp: bool = True,
    shear_warp_base_res: Optional[int] = None,
    steps_per_call: int = 1,
) -> None:
    """Train the edit / object attention grids against SD's cross-attention
    maps on the grids' device, then graph-cut and merge (the reference's
    attn_grid_trainer). Both renders of an iteration run on the shear-warp
    path by default, in base-plane space (a square lattice of
    `shear_warp_base_res`, by default `lane_aligned_res(max(H, W))`), so the
    attention targets and renders line up with no warp; `use_shear_warp=False`
    takes the exact renderer on full frames. Writes
    `output_dir/saved_models/model_{edit,object}_iter_<n>.pth`, then
    `model_final_attn_edit.pth`, `model_final_attn_object.pth` and
    `model_final_refined.pth`; feedback PNGs go to
    `output_dir/training_logs/rendered_output`. With `steps_per_call` K > 1
    on the shear-warp path in random-pose mode, K iterations run a call
    (`make_refine_multi_step`) and summary, feedback and snapshots follow
    the JAX package's K-step cadence: when the step is within K of a multiple
    of the frequency, on the first call and on the last.

    `num_devices > 1` shards every iteration's renders over that many
    processes of the initialised default group (`maybe_mesh`); the
    attention grids are replicated from rank 0 at start, and only the
    process with local rank 0 renders feedback and writes files (the others
    still take the feedback's attention maps, which draw from the
    generator, so every rank draws alike). Every rank runs the graph cut."""
    if prompt == "none":
        raise ValueError("you have to supply a text prompt")
    mesh = maybe_mesh(num_devices)
    if mesh is not None:
        log.info(f"refinement: ray-DP over {num_devices} devices")
    writer = is_local_writer()
    del hf_auth_token, ray_batch_size, scale_factor, apply_diffuse_render_regularization, verbose_rendering
    output_dir = Path(output_dir)
    im_h, im_w = image_dims
    sw_res = shear_warp_base_res or lane_aligned_res(max(im_h, im_w))
    sw_hw = (sw_res, sw_res)
    if use_shear_warp:  # the render clamps an eye inside the volume: check the pose source first
        if data_pose_mode:
            check_shear_warp_poses(vol_mod_edit.grid, np.asarray(train_dataset.poses), "refinement (dataset poses)")
        else:
            check_shear_warp_hemisphere(vol_mod_edit.grid, HEMISPHERICAL_RADIUS_CONSTANT, "refinement (hemisphere poses)")
    if isinstance(edit_idx, int):
        edit_idx = [edit_idx]

    dev = vol_mod_edit.grid.densities.device
    # the reference's refinement stage runs SD 1.4
    sd = sd_model or StableDiffusion(sd_version, config=sd_config, weights_dir=sd_weights_dir, device=dev)
    if isinstance(sd.tokenizer, HashTokenizer) and sd.config.version != "tiny":
        log.warning(
            "refinement is running with the hash tokenizer: edit_idx / object_idx are hash-token "
            "positions, not CLIP BPE tokens. Give sd_weights_dir a tokenizer/ for real token indices."
        )

    camera_intrinsics = train_dataset.camera_intrinsics
    extra_info = {
        CAMERA_BOUNDS: list(train_dataset.camera_bounds),
        CAMERA_INTRINSICS: list(camera_intrinsics),
        HEMISPHERICAL_RADIUS: train_dataset.get_hemispherical_radius_estimate(),
    }
    model_dir = output_dir / "saved_models"
    render_dir = output_dir / "training_logs" / "rendered_output"
    if writer:
        for d in (model_dir, render_dir):
            d.mkdir(parents=True, exist_ok=True)

    # two optimizers over the two attention grids only; densities and features stay frozen
    schedule = exponential_decay_staircase(learning_rate, lr_decay_steps_per_stage, lr_decay_gamma_per_stage)
    edit_attn = vol_mod_edit.grid.attn.detach().clone()
    obj_attn = vol_mod_object.grid.attn.detach().clone()
    optimizer_edit = make_attn_adam(edit_attn, learning_rate)
    optimizer_object = make_attn_adam(obj_attn, learning_rate)
    if mesh is not None:
        replicate(mesh, [edit_attn, obj_attn])
    g = vol_mod_edit.grid
    base_grid = g.replace(densities=g.densities.detach(), features=g.features.detach())
    render_config = vol_mod_edit.render_config

    if use_shear_warp:
        refine_iter = make_refine_iter_shearwarp(
            sd, render_config, optimizer_edit, optimizer_object, base_grid, sw_hw, timestamp, attn_tv_weight, schedule,
            mesh,
        )
        dir_selection = {
            d: token_selection(sd.get_num_tokens(prompt + f", {d} view"), edit_idx, object_idx)
            for d in DIRECTION_PROMPTS
        }
        feedback_config = render_config.replace(stochastic_density_noise_std=0.0)

        @torch.no_grad()
        def frame_sw(attn, rotation, translation, attn_mode):
            out, _ = render_shear_warp(
                base_grid.replace(attn=attn), CameraPose(rotation, translation), feedback_config,
                base_hw=sw_hw, attn_mode=attn_mode, background_value=0.0 if attn_mode else 1.0,
            )
            if attn_mode:
                return orient_base_image(out.colour[..., 0].reshape(*sw_hw), rotation)
            return orient_base_image(out.colour.reshape(*sw_hw, 3), rotation)[None]
    else:
        attn_step = make_attn_train_step(
            render_config, optimizer_edit, optimizer_object, base_grid, attn_tv_weight, schedule, mesh
        )

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if data_pose_mode:
        batch_iter = train_dataset.iter_batches(1, rng)

    def targets_from_maps(gt_maps, num_tokens):
        edit_map = torch.stack([gt_maps[i - 1] for i in edit_idx], -1).amax(-1)
        if object_idx is not None:
            return edit_map, gt_maps[object_idx - 1]
        non_edit = [gt_maps[i - 1] for i in range(1, num_tokens + 1) if i not in edit_idx]
        return edit_map, (torch.stack(non_edit, -1).amax(-1) if non_edit else torch.zeros_like(edit_map))

    def emit_feedback(global_step, pose, rot, trans, m_prompt, edit_map=None, obj_map=None, rays=None):
        """Target maps, per-grid attention-render diagnostics, the
        edit-vs-object render difference and the attention feedback frame."""
        from voxe_tpu_torch.viz.refinement import (
            visualize_attention_maps,
            visualize_attn_render_diagnostics,
            visualize_render_diff,
        )
        from voxe_tpu_torch.viz.static import visualize_sh_vox_grid_vol_mod_rendered_feedback_attn

        e_attn, o_attn = edit_attn.detach(), obj_attn.detach()
        if use_shear_warp:  # the iteration keeps its maps: recompute them for the diagnostics
            num_tokens = sd.get_num_tokens(m_prompt)
            gt_maps, _ = sd.get_attn_map(  # on every rank: it draws from the generator
                m_prompt, frame_sw(e_attn, rot, trans, False), timestamp,
                list(range(1, num_tokens + 1)), generator=gen,
            )
            if not writer:
                return
            edit_map, obj_map = targets_from_maps(gt_maps, num_tokens)
            edit_render = frame_sw(e_attn, rot, trans, True)
            obj_render = frame_sw(o_attn, rot, trans, True)
        else:
            if not writer:
                return
            with torch.no_grad():
                edit_render, obj_render = (
                    render_sh_voxel_grid_attn(base_grid.replace(attn=a), rays, render_config).colour[..., 0].reshape(im_h, im_w)
                    for a in (e_attn, o_attn)
                )
        visualize_attention_maps(edit_map, obj_map, global_step, render_dir)
        visualize_attn_render_diagnostics(edit_render, edit_map, "edit", global_step, render_dir)
        visualize_attn_render_diagnostics(obj_render, obj_map, "object", global_step, render_dir)
        visualize_render_diff(edit_render, obj_render, global_step, render_dir)
        visualize_sh_vox_grid_vol_mod_rendered_feedback_attn(
            VolumetricModel(base_grid.replace(attn=e_attn), render_config), "attn",
            render_feedback_pose or pose, camera_intrinsics, global_step, render_dir, use_shear_warp=use_shear_warp,
        )

    def save_snapshots(global_step):
        if not writer:
            return
        for name, attn in (("edit", edit_attn), ("object", obj_attn)):
            VolumetricModel(base_grid.replace(attn=attn.detach()), render_config).save(
                model_dir / f"model_{name}_iter_{global_step}.pth", extra_info=extra_info
            )

    use_fused = use_shear_warp and steps_per_call > 1 and not data_pose_mode
    log.info(
        f"beginning attn-grid refinement: grid {base_grid.grid_dims}, frame [{im_h} x {im_w}], "
        f"prompt '{prompt}', edit_idx {edit_idx}" + (f", {steps_per_call} iterations a call" if use_fused else "")
    )
    time_training = 0.0
    if use_fused:
        text_by_dir = torch.stack([sd.get_text_embeds(prompt + f", {d} view", "") for d in DIRECTION_PROMPTS])
        selection_by_dir = [dir_selection[d] for d in DIRECTION_PROMPTS]
        multi_steps = {}
        for chunk_start in range(1, num_iterations + 1, steps_per_call):
            # the last call may be partial: exactly num_iterations updates
            chunk = min(steps_per_call, num_iterations - chunk_start + 1)
            if chunk not in multi_steps:
                multi_steps[chunk] = make_refine_multi_step(
                    sd, render_config, optimizer_edit, optimizer_object, base_grid, sw_hw, timestamp,
                    attn_tv_weight, chunk, HEMISPHERICAL_RADIUS_CONSTANT, schedule, mesh,
                )
            last_time = time.perf_counter()
            metrics = multi_steps[chunk](edit_attn, obj_attn, text_by_dir, selection_by_dir, gen)
            _sync(dev)
            time_training += time.perf_counter() - last_time
            global_step = chunk_start + chunk - 1
            last_iter = global_step >= num_iterations
            if global_step % summary_freq < steps_per_call or chunk_start == 1 or last_iter:
                log.info(
                    f"Iteration: {global_step} attn_loss: {float(metrics['attn_loss_edit']):.4f} "
                    f"obj: {float(metrics['attn_loss_object']):.4f}"
                )
            if (global_step % feedback_freq < steps_per_call or chunk_start == 1 or last_iter) and not fast_debug_mode:
                # the chunk's poses were drawn on the device: feedback takes a fresh host pose
                pose, direction, _, _ = get_random_pose(HEMISPHERICAL_RADIUS_CONSTANT, rng)
                rot = torch.as_tensor(np.asarray(pose.rotation, np.float32), device=dev)
                trans = torch.as_tensor(np.asarray(pose.translation, np.float32), device=dev).reshape(3, 1)
                emit_feedback(global_step, pose, rot, trans, prompt + f", {direction} view")
            if global_step % save_freq < steps_per_call or last_iter:
                save_snapshots(global_step)

    for global_step in range(1, num_iterations + 1) if not use_fused else ():
        last_time = time.perf_counter()
        if data_pose_mode:
            pose_arr = train_dataset.poses[next(batch_iter)[0]]
            pose = CameraPose(rotation=pose_arr[:, :3], translation=pose_arr[:, 3:])
            direction = get_dir_batch_from_poses(pose_arr[None])[0]
        else:
            pose, direction, _, _ = get_random_pose(HEMISPHERICAL_RADIUS_CONSTANT, rng)
        rot = torch.as_tensor(np.asarray(pose.rotation, np.float32), device=dev)
        trans = torch.as_tensor(np.asarray(pose.translation, np.float32), device=dev).reshape(3, 1)
        m_prompt = prompt + f", {direction} view"
        rays = edit_map = obj_map = None
        if use_shear_warp:
            idxs, emask, omask = dir_selection[direction]
            metrics = refine_iter(
                edit_attn, obj_attn, sd.get_text_embeds(m_prompt, ""), rot, trans, idxs, emask, omask, generator=gen
            )
        else:
            rays = flatten_rays(cast_rays(camera_intrinsics, rot, trans))
            rgb = VolumetricModel(base_grid.replace(attn=edit_attn.detach()), render_config).render(camera_intrinsics, pose)
            num_tokens = sd.get_num_tokens(m_prompt)
            gt_maps, _ = sd.get_attn_map(
                m_prompt, rgb.colour[None], timestamp, list(range(1, num_tokens + 1)), generator=gen
            )
            edit_map, obj_map = targets_from_maps(gt_maps, num_tokens)
            metrics = attn_step(edit_attn, obj_attn, rays, edit_map, obj_map, generator=gen)
        _sync(dev)
        time_training += time.perf_counter() - last_time
        last_iter = global_step == num_iterations

        if global_step % summary_freq == 0 or global_step == 1 or last_iter:
            log.info(
                f"Iteration: {global_step} attn_loss: {float(metrics['attn_loss_edit']):.4f} "
                f"obj: {float(metrics['attn_loss_object']):.4f}"
            )
        if (global_step % feedback_freq == 0 or global_step == 1 or last_iter) and not fast_debug_mode:
            emit_feedback(global_step, pose, rot, trans, m_prompt, edit_map, obj_map, rays)
        if global_step % save_freq == 0 or global_step == 1 or last_iter:
            save_snapshots(global_step)

    # graph cut + voxel merge
    log.info("starting grid refinement (graph cut + merge)!")
    vol_mod_edit.grid = vol_mod_edit.grid.replace(attn=edit_attn.detach())
    vol_mod_object.grid = vol_mod_object.grid.replace(attn=obj_attn.detach())
    t0 = time.perf_counter()
    segments, idxs = get_edit_region(
        vol_mod_edit=vol_mod_edit,
        vol_mod_object=vol_mod_object,
        vol_mod_output=vol_mod_output,
        viz_dir=None if fast_debug_mode or not writer else render_dir,
        K=kval,
        edit_mask_thresh=edit_mask_thresh,
        num_obj_voxels_thresh=num_obj_voxels_thresh,
        min_num_edit_voxels=min_num_edit_voxels,
        top_k_edit_thresh=top_k_edit_thresh,
        top_k_obj_thresh=top_k_obj_thresh,
        downsample_grid=downsample_refine_grid,
    )
    merge_edit_region(vol_mod_output, vol_mod_ref)
    graph_cut_s = time.perf_counter() - t0

    if writer:
        vol_mod_edit.save(model_dir / "model_final_attn_edit.pth", extra_info=extra_info)
        vol_mod_object.save(model_dir / "model_final_attn_object.pth", extra_info=extra_info)
        vol_mod_output.save(model_dir / "model_final_refined.pth", extra_info=extra_info)
    log.info(
        f"Refinement complete; actual training time: {timedelta(seconds=time_training)}",
        extra={
            "time_training": time_training, "num_iterations": num_iterations, "graph_cut_s": graph_cut_s,
            "graph_cut_nodes": int(len(idxs)), "edit_voxels": int((segments == 0).sum()),
        },
    )

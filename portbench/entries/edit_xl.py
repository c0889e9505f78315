"""Entry `edit_xl`: the program's SDS edit step with SDXL base 1.0 as the
prior, in random-pose mode, one step a call, as the edit CLI runs it with
`--sd_version xl` (`train/sds.py::make_sds_train_multi_step` on the
shear-warp path): each call draws a hemisphere pose, buckets its view
direction to pick the prompt's context, pooled row and time ids, draws t
in the schedule's starting bounds, renders the base-plane frame, resizes it
to 1024^2 and encodes it with the VAE, runs the CFG UNet (its CUDA graph on
the card), injects the SDS gradient, adds density correlation against the
starting grid, runs the backward and one Adam update of the grid.

The program's SDXL is built here from the configuration's "sd" group (the
glue of `portbench.lib.program` for SD 1.x / 2.x reads one text tower) and
takes the run's seeded weights, named as in the published checkpoint,
through the program's own loader. Its faults are the edit entry's: the same
functions of the program carry the SDS gradient and the guidance.
"""
from __future__ import annotations

import torch

from portbench.entries.edit import FAULTS  # noqa: F401
from portbench.lib import inputs, program
from portbench.lib.check import program_readings
from portbench.lib.seeds import generator
from portbench.lib.session import Session
from portbench.lib.weights import draw
from portbench.reference import sdxl
from portbench.reference import steps_xl
from portbench.reference.precision import Rounding
from portbench.reference.render import GridSpec

reference = steps_xl.edit_xl
# the program's module name -> the published checkpoint's subfolder
SD_MODULES = (("clip", "text_encoder"), ("clip_2", "text_encoder_2"), ("vae", "vae"), ("unet", "unet"))


def _clip(te: dict):
    from voxe_tpu_torch.models.sd.config import CLIPTextConfig

    return CLIPTextConfig(
        vocab_size=te["vocab_size"], hidden_size=te["hidden_size"], intermediate_size=te["intermediate_size"],
        num_hidden_layers=te["num_hidden_layers"], num_attention_heads=te["num_attention_heads"],
        max_position_embeddings=te["max_position_embeddings"], hidden_act=te["hidden_act"],
        layer_norm_eps=te["layer_norm_eps"], projection_dim=te.get("projection_dim"),
    )


def sd_config(s: dict):
    """The program's SDConfig for an SDXL "sd" group."""
    from voxe_tpu_torch.models.sd.config import SDConfig, UNetConfig, VAEConfig

    vae, unet, sched = s["vae"], s["unet"], s["scheduler"]
    return SDConfig(
        version=s["version"],
        clip=_clip(s["text_encoder"]),
        clip_2=_clip(s["text_encoder_2"]),
        vae=VAEConfig(
            in_channels=vae["in_channels"], out_channels=vae["out_channels"], latent_channels=vae["latent_channels"],
            block_out_channels=tuple(vae["block_out_channels"]), layers_per_block=vae["layers_per_block"],
            norm_num_groups=vae["norm_num_groups"], scaling_factor=vae["scaling_factor"],
        ),
        unet=UNetConfig(
            sample_size=unet["sample_size"], in_channels=unet["in_channels"], out_channels=unet["out_channels"],
            block_out_channels=tuple(unet["block_out_channels"]), layers_per_block=unet["layers_per_block"],
            cross_attention_dim=unet["cross_attention_dim"], attention_head_dim=tuple(unet["attention_head_dim"]),
            norm_num_groups=unet["norm_num_groups"], down_block_types=tuple(unet["down_block_types"]),
            up_block_types=tuple(unet["up_block_types"]), flip_sin_to_cos=unet["flip_sin_to_cos"],
            freq_shift=unet["freq_shift"], transformer_layers_per_block=tuple(unet["transformer_layers_per_block"]),
            addition_embed_type=unet["addition_embed_type"], addition_time_embed_dim=unet["addition_time_embed_dim"],
            projection_class_embeddings_input_dim=unet["projection_class_embeddings_input_dim"],
        ),
        num_train_timesteps=sched["num_train_timesteps"], beta_start=sched["beta_start"],
        beta_end=sched["beta_end"], image_size=s["image_size"], add_time_ids=tuple(s["add_time_ids"]),
    )


def build_sd(cfg: dict, seed: int, device):
    """The program's SDXL at the configuration's widths and dtypes, with the
    run's seeded weights (named as in the published checkpoint, converted by
    the program's loader), one module at a time."""
    from voxe_tpu_torch.models.sd.sds import StableDiffusion
    from voxe_tpu_torch.models.sd.weights import NAME_FNS, convert_hf_tensors

    s = cfg["sd"]
    dtypes = s["dtypes"]
    model = StableDiffusion(
        config=sd_config(s), init_mode="zeros", unet_dtype=program.DTYPES[dtypes["unet"]],
        vae_dtype=program.DTYPES[dtypes["vae"]], device=device,
    )
    names = sdxl.build(s, {k: Rounding() for k in sdxl.MODULES})  # names, shapes
    for port_name, hf_name in SD_MODULES:
        tensors = draw(names[hf_name], generator(seed, f"weights.{hf_name}", device), program.DTYPES[dtypes[hf_name]])
        module = getattr(model, port_name)
        module.load_state_dict(convert_hf_tensors(module, tensors, NAME_FNS[port_name]), strict=True)
        del tensors
    return model


def setup(cfg: dict, cell: dict, seed: int, device) -> Session:
    from voxe_tpu_torch.grid.voxels import VoxelGrid
    from voxe_tpu_torch.models.sd.sds import empty_negative_pairs
    from voxe_tpu_torch.train import sds as train_sds
    from voxe_tpu_torch.train.recon import exponential_decay_staircase, make_adam
    from voxe_tpu_torch.utils.camera import CameraIntrinsics

    e = cfg["edit"]
    spec = GridSpec.from_config(cfg["grid"])
    model = build_sd(cfg, seed, device)
    ids = inputs.token_ids(seed, cfg["sd"]["text_encoder"], e["prompt_tokens"], device)[:, 1]  # conditional rows
    text_by_dir = empty_negative_pairs(model.encode_text_xl(ids, ids))
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

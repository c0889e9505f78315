"""Glue between a configuration file and the program under test: the
program's Stable Diffusion built at the configuration's widths, its
weights handed over through the program's own loader for published
checkpoints (`convert_hf_tensors`), and the voxel-grid configuration."""
from __future__ import annotations

import torch

from portbench.lib.seeds import generator
from portbench.lib.weights import draw
from portbench.reference import sd as ref_sd
from portbench.reference.precision import Rounding
from portbench.reference.render import GridSpec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the program's module name -> the published checkpoint's subfolder
SD_MODULES = (("clip", "text_encoder"), ("vae", "vae"), ("unet", "unet"))


def sd_config(s: dict):
    """The program's SDConfig for the configuration's "sd" group."""
    from voxe_tpu_torch.models.sd.config import CLIPTextConfig, SDConfig, UNetConfig, VAEConfig

    te, vae, unet, sched = s["text_encoder"], s["vae"], s["unet"], s["scheduler"]
    return SDConfig(
        version=s["version"],
        clip=CLIPTextConfig(
            vocab_size=te["vocab_size"], hidden_size=te["hidden_size"], intermediate_size=te["intermediate_size"],
            num_hidden_layers=te["num_hidden_layers"], num_attention_heads=te["num_attention_heads"],
            max_position_embeddings=te["max_position_embeddings"], hidden_act=te["hidden_act"],
            layer_norm_eps=te["layer_norm_eps"],
        ),
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
            freq_shift=unet["freq_shift"],
        ),
        num_train_timesteps=sched["num_train_timesteps"], beta_start=sched["beta_start"],
        beta_end=sched["beta_end"], image_size=s["image_size"],
    )


def build_sd(cfg: dict, seed: int, device):
    """The program's StableDiffusion at the configuration's widths and
    dtypes, with the run's seeded weights (named as in the published
    checkpoints, converted by the program's loader)."""
    from voxe_tpu_torch.models.sd.sds import StableDiffusion
    from voxe_tpu_torch.models.sd.weights import NAME_FNS, convert_hf_tensors

    s = cfg["sd"]
    model = StableDiffusion(
        config=sd_config(s), init_mode="zeros", unet_dtype=DTYPES[s["dtypes"]["unet"]],
        vae_dtype=DTYPES[s["dtypes"]["vae"]], device=device,
    )
    names = ref_sd.build(ref_sd.SDShapes.from_config(s), {k: Rounding() for k in s["dtypes"]})  # names, shapes
    for port_name, hf_name in SD_MODULES:
        tensors = draw(names[hf_name], generator(seed, f"weights.{hf_name}", device), DTYPES[s["dtypes"][hf_name]])
        module = getattr(model, port_name)
        module.load_state_dict(convert_hf_tensors(module, tensors, NAME_FNS[port_name]), strict=True)
        del tensors
    return model


def grid_config(grid: dict):
    """The program's VoxelGridConfig for the configuration's "grid" group."""
    from voxe_tpu_torch.grid.voxels import VoxelGridConfig, VoxelSize

    spec = GridSpec.from_config(grid)
    return VoxelGridConfig(
        voxel_size=VoxelSize(*[spec.voxel] * 3),
        density_preactivation=spec.density_preactivation, density_postactivation=spec.density_postactivation,
        feature_preactivation=spec.feature_preactivation, feature_postactivation=spec.feature_postactivation,
        expected_density_scale=spec.density_scale, gather_dtype=grid["gather_dtype"],
    )


def render_config(stage: dict):
    """The program's render configuration of a stage ("edit", "refine",
    "recon"): white background, no density noise, the compositing kernel as
    the stage's checkpoint says. The sample count and bounds are the CLIs';
    the shear-warp path samples once a slice and reads neither."""
    from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
    from voxe_tpu_torch.utils.camera import CameraBounds

    return SHVoxGridRenderConfig(
        num_samples_per_ray=256, camera_bounds=CameraBounds(2.0, 6.0), white_bkgd=True,
        use_fused_kernel=bool(stage["use_fused_kernel"]),
    )

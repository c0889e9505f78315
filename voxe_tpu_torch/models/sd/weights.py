"""Parameters from HF snapshots and from the JAX package's trees
(counterpart of voxe_tpu/models/sd/weights.py).

The port's submodules carry the flax module names, so every state-dict key
is a flax path joined with "." and its flax leaf follows from the module
type (Linear/Conv `weight` <- `kernel`, norm `weight` <- `scale`,
Embedding `weight` <- `embedding`, `bias`). Two sources:

* `load_sd_params(weights_dir, config)` reads a local HF snapshot
  (`text_encoder/`, `vae/`, `unet/`, and SDXL's `text_encoder_2/`, each
  holding *.safetensors or *.bin)
  with the JAX package's name maps (copied below): each port key gets its
  list of HF candidate names and takes the first one present. HF tensors
  are already in torch layout; what stays is the 1x1 reshape between a
  conv and a linear in either direction (SD 1.x `proj_in`/`proj_out` and
  the legacy VAE attention are 1x1 convs in HF and linears or convs here;
  SD 2.x `use_linear_projection` stores linears where the port has 1x1
  convs). Every tensor's shape is checked against the module's.
* `from_flax_params(params)` carries a nested flax tree (numpy leaves)
  across: Dense kernels [in, out] -> [out, in], Conv kernels HWIO -> OIHW.

The safetensors format is read here (an 8-byte little-endian header length,
a JSON header of dtype / shape / data_offsets, then raw bytes): F32, F16 and
BF16. Nothing here imports the JAX package or the safetensors package.
"""
from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig
from voxe_tpu_torch.models.sd.config import SDConfig
from voxe_tpu_torch.models.sd.norms import GroupNorm
from voxe_tpu_torch.utils.logging import log

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


# ----------------------------------------------------------------------------------
# source tensor files
# ----------------------------------------------------------------------------------


def read_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    """All tensors of one .safetensors file as CPU tensors of their stored
    dtype (F32, F16 or BF16; any other dtype raises)."""
    tensors: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        header.pop("__metadata__", None)
        base = 8 + header_len
        for name, info in header.items():
            if info["dtype"] not in SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; F32, F16 or BF16 only")
            dtype = SAFETENSORS_DTYPES[info["dtype"]]
            start, end = info["data_offsets"]
            buf = bytearray(end - start)
            f.seek(base + start)
            if f.readinto(buf) != end - start:
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            flat = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            tensors[name] = flat.reshape(info["shape"])
    return tensors


def load_tensor_files(subdir: Path) -> Dict[str, torch.Tensor]:
    """Every tensor under an HF model subfolder: its *.safetensors files, or
    else its *.bin files (torch.load with weights_only)."""
    subdir = Path(subdir)
    if not subdir.is_dir():
        raise FileNotFoundError(f"no HF model subfolder {subdir}")
    tensors: Dict[str, torch.Tensor] = {}
    st_files = sorted(subdir.glob("*.safetensors"))
    for f in st_files:
        tensors.update(read_safetensors(f))
    if st_files:
        return tensors
    bin_files = sorted(subdir.glob("*.bin"))
    for f in bin_files:
        tensors.update(torch.load(f, map_location="cpu", weights_only=True))
    if not bin_files:
        raise FileNotFoundError(f"no .safetensors or .bin files under {subdir}")
    return tensors


# ----------------------------------------------------------------------------------
# HF names of flax paths (a copy of voxe_tpu/models/sd/weights.py:88-296)
# ----------------------------------------------------------------------------------


def _hf_names_for_clip(path: str) -> list:
    p = "text_model."
    m = re.match(r"layers_(\d+)/(.*)", path)
    if path.startswith("token_embedding"):
        return [p + "embeddings.token_embedding.weight"]
    if path.startswith("position_embedding"):
        return [p + "embeddings.position_embedding.weight"]
    if path.startswith("text_projection"):  # CLIPTextModelWithProjection's pooled projection
        return ["text_projection.weight"]
    if path.startswith("final_layer_norm"):
        leaf = path.split("/")[-1]
        suffix = "weight" if leaf == "scale" else "bias"
        return [p + f"final_layer_norm.{suffix}"]
    assert m, path
    i, rest = m.group(1), m.group(2)
    rest = rest.replace("mlp_fc1", "mlp.fc1").replace("mlp_fc2", "mlp.fc2")
    rest = rest.replace("/kernel", ".weight").replace("/bias", ".bias")
    rest = rest.replace("/scale", ".weight")
    rest = rest.replace("self_attn/", "self_attn.")
    return [p + f"encoder.layers.{i}.{rest}"]


def _vae_block_name(path: str, side: str) -> str:
    m = re.match(r"(down|up)_(\d+)_resnet_(\d+)", path)
    if m:
        kind = "down_blocks" if m.group(1) == "down" else "up_blocks"
        return f"{side}.{kind}.{m.group(2)}.resnets.{m.group(3)}"
    m = re.match(r"down_(\d+)_downsample", path)
    if m:
        return f"{side}.down_blocks.{m.group(1)}.downsamplers.0.conv"
    m = re.match(r"up_(\d+)_upsample", path)
    if m:
        return f"{side}.up_blocks.{m.group(1)}.upsamplers.0.conv"
    m = re.match(r"mid_resnet_(\d+)", path)
    if m:
        return f"{side}.mid_block.resnets.{m.group(1)}"
    if path == "mid_attn":
        return f"{side}.mid_block.attentions.0"
    if path in ("conv_in", "conv_out", "conv_norm_out"):
        return f"{side}.{path}"
    raise KeyError(path)


# current diffusers names first, then the legacy VAE attention names
_VAE_ATTN_ALIASES = {
    "to_q": ("to_q", "query", "q"),
    "to_k": ("to_k", "key", "k"),
    "to_v": ("to_v", "value", "v"),
    "to_out": ("to_out.0", "proj_attn", "proj_out"),
    "group_norm": ("group_norm", "norm"),
}


def _leaf_suffix(leaf: str) -> str:
    return {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}[leaf]


def clip_name_fn(path: str):
    leaf = path.split("/")[-1]
    names = _hf_names_for_clip(path)
    if "layer_norm" in path or leaf == "scale":
        kind = "norm"
    elif leaf == "embedding":
        kind = "embed"
    else:
        kind = "linear"
    return names, kind


def vae_name_fn(path: str):
    parts = path.split("/")
    suffix = _leaf_suffix(parts[-1])
    if parts[0] in ("quant_conv", "post_quant_conv"):
        return [f"{parts[0]}.{suffix}"], "conv"
    side, rest = parts[0], parts[1:]
    base = _vae_block_name(rest[0], side)
    if rest[0] == "mid_attn":
        sub = rest[1]
        aliases = _VAE_ATTN_ALIASES.get(sub, (sub,))
        kind = "norm" if sub == "group_norm" else "linear"
        return [f"{base}.{a}.{suffix}" for a in aliases], kind
    if len(rest) == 2:  # (module, leaf): conv_in/conv_out/conv_norm_out/down/upsample
        kind = "norm" if "norm" in rest[0] else "conv"
        return [f"{base}.{suffix}"], kind
    sub = rest[1]  # resnet submodule
    kind = "norm" if sub.startswith("norm") else "conv"
    return [f"{base}.{sub}.{suffix}"], kind


def unet_name_fn(path: str):
    parts = path.split("/")
    suffix = _leaf_suffix(parts[-1])
    top = parts[0]
    if top in ("conv_in", "conv_out"):
        return [f"{top}.{suffix}"], "conv"
    if top == "conv_norm_out":
        return [f"conv_norm_out.{suffix}"], "norm"
    m = re.match(r"(time_embedding|add_embedding)_linear_(\d)", top)
    if m:
        return [f"{m.group(1)}.linear_{m.group(2)}.{suffix}"], "linear"

    m = re.match(r"(down|up)_(\d+)_(resnet|attn|downsample|upsample)_?(\d+)?", top)
    if top.startswith("mid_"):
        m2 = re.match(r"mid_resnet_(\d+)", top)
        base = f"mid_block.resnets.{m2.group(1)}" if m2 else "mid_block.attentions.0"
        block_kind = "resnet" if m2 else "attn"
    else:
        assert m, path
        direction = "down_blocks" if m.group(1) == "down" else "up_blocks"
        idx, kind_name, j = m.group(2), m.group(3), m.group(4)
        if kind_name == "resnet":
            base, block_kind = f"{direction}.{idx}.resnets.{j}", "resnet"
        elif kind_name == "attn":
            base, block_kind = f"{direction}.{idx}.attentions.{j}", "attn"
        elif kind_name == "downsample":
            return [f"{direction}.{idx}.downsamplers.0.conv.{suffix}"], "conv"
        else:
            return [f"{direction}.{idx}.upsamplers.0.conv.{suffix}"], "conv"

    rest = parts[1:]
    if block_kind == "resnet":
        sub = rest[0]
        kind = "norm" if sub.startswith("norm") else ("linear" if sub == "time_emb_proj" else "conv")
        return [f"{base}.{sub}.{suffix}"], kind
    sub = rest[0]  # transformer block
    if sub == "norm":
        return [f"{base}.norm.{suffix}"], "norm"
    if sub in ("proj_in", "proj_out"):  # a 1x1 conv in SD 1.x, a linear in SD 2.x
        return [f"{base}.{sub}.{suffix}"], "conv"
    m = re.fullmatch(r"transformer_blocks_(\d+)", sub)
    assert m, path
    inner = rest[1]
    tb = f"{base}.transformer_blocks.{m.group(1)}"
    if inner.startswith("norm"):
        return [f"{tb}.{inner}.{suffix}"], "norm"
    if inner in ("attn1", "attn2"):
        proj = rest[2].replace("to_out_0", "to_out.0")
        return [f"{tb}.{inner}.{proj}.{suffix}"], "linear"
    assert inner == "ff", path
    sub_ff = {"geglu_proj": "net.0.proj", "out_proj": "net.2"}[rest[2]]
    return [f"{tb}.ff.{sub_ff}.{suffix}"], "linear"


NAME_FNS: Dict[str, Callable] = {"clip": clip_name_fn, "clip_2": clip_name_fn, "vae": vae_name_fn, "unet": unet_name_fn}
HF_SUBFOLDERS = {"clip": "text_encoder", "clip_2": "text_encoder_2", "vae": "vae", "unet": "unet"}


# ----------------------------------------------------------------------------------
# port keys <-> HF names
# ----------------------------------------------------------------------------------


def flax_path(module: nn.Module, key: str) -> str:
    """A state-dict key of the port -> its flax tree path ("a/b/kernel")."""
    prefix, name = key.rsplit(".", 1)
    sub = module.get_submodule(prefix)
    if name == "bias":
        leaf = "bias"
    elif isinstance(sub, (nn.LayerNorm, GroupNorm)):
        leaf = "scale"
    elif isinstance(sub, nn.Embedding):
        leaf = "embedding"
    else:
        leaf = "kernel"
    return prefix.replace(".", "/") + "/" + leaf


def hf_names(module: nn.Module, name_fn: Callable) -> Dict[str, Tuple[List[str], str]]:
    """{port key: (HF candidate names, module kind)} for every parameter."""
    return {key: name_fn(flax_path(module, key)) for key in module.state_dict()}


def _to_port_layout(src: torch.Tensor, kind: str, shape) -> torch.Tensor:
    if kind == "linear" and src.ndim == 4 and src.shape[2:] == (1, 1):
        src = src[:, :, 0, 0]  # HF 1x1 conv where the port has a linear
    elif kind == "conv" and src.ndim == 2 and len(shape) == 4:
        src = src[:, :, None, None]  # HF linear where the port has a 1x1 conv
    return src


def convert_hf_tensors(module: nn.Module, tensors: Mapping[str, torch.Tensor], name_fn: Callable) -> Dict[str, torch.Tensor]:
    """HF tensors -> a state dict for `module` (stored dtypes kept;
    `load_state_dict` casts). Raises on a missing name or a shape mismatch."""
    out = {}
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    for key, (candidates, kind) in hf_names(module, name_fn).items():
        name = next((c for c in candidates if c in tensors), None)
        if name is None:
            raise KeyError(f"none of {candidates} found in checkpoint (for {key})")
        t = _to_port_layout(tensors[name], kind, shapes[key])
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{key}: {name} has shape {tuple(tensors[name].shape)}, the module wants {shapes[key]}")
        out[key] = t
    return out


def build_sd_modules(config: SDConfig, device="cpu") -> Dict[str, nn.Module]:
    """The port's CLIP, VAE and UNet for `config` (and SDXL's second tower,
    "clip_2"), built on `device` ("meta" builds no weights)."""
    from voxe_tpu_torch.models.sd.clip_text import CLIPTextModel
    from voxe_tpu_torch.models.sd.unet import UNet2DConditionModel
    from voxe_tpu_torch.models.sd.vae import AutoencoderKL

    with torch.device(device):
        modules = {
            "clip": CLIPTextModel(config.clip),
            "vae": AutoencoderKL(config.vae),
            "unet": UNet2DConditionModel(config.unet),
        }
        if config.clip_2 is not None:
            modules["clip_2"] = CLIPTextModel(config.clip_2)
        return modules


def load_sd_params(weights_dir: Path, config: SDConfig) -> Dict[str, Dict[str, torch.Tensor]]:
    """An HF snapshot directory -> {"clip", "vae", "unet"} state dicts for
    the port's modules at `config`, and "clip_2" from `text_encoder_2/` for
    SDXL (CPU tensors of the stored dtypes)."""
    weights_dir = Path(weights_dir)
    log.info(f"loading HF checkpoint from {weights_dir} ...")
    modules = build_sd_modules(config, device="meta")
    return {
        name: convert_hf_tensors(module, load_tensor_files(weights_dir / HF_SUBFOLDERS[name]), NAME_FNS[name])
        for name, module in modules.items()
    }


# ----------------------------------------------------------------------------------
# flax trees (the JAX package's parameters)
# ----------------------------------------------------------------------------------


def _leaf(name: str, value: np.ndarray):
    value = np.asarray(value)
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    if name == "bias":
        return "bias", value
    raise KeyError(f"unknown flax leaf {name!r}")


def from_flax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> torch state_dict (float32 CPU
    tensors; `load_state_dict` casts them to the module's dtype/device)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + key + ".")
            else:
                name, arr = _leaf(key, value)
                out[prefix + name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    walk(params, "")
    return out


def voxel_grid_from_numpy(
    densities: np.ndarray, features: np.ndarray, config: VoxelGridConfig, device="cuda",
    attn: Optional[np.ndarray] = None, orig_densities: Optional[np.ndarray] = None,
) -> VoxelGrid:
    """A float32 VoxelGrid on `device` from numpy arrays (attention field and
    frozen densities carried across when given)."""
    def to(x):
        return None if x is None else torch.as_tensor(np.asarray(x, np.float32), device=device)

    return VoxelGrid(
        densities=to(densities), features=to(features), config=config,
        attn=to(attn), orig_densities=to(orig_densities),
    )

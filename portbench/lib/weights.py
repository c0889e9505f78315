"""Seeded weights at the published widths, under the published checkpoints'
parameter names, made on the device.

The names and shapes come from the reference's modules (built on the meta
device, so they cost nothing). The draws are a few large standard-normal
calls in the dtype the weights are served in, one per bucket of at most
`BUCKET` elements over the sorted names, and each leaf is then scaled:
linear, convolution and embedding weights by 1/sqrt(fan_in), biases by
0.02, norm weights to 1 + 0.1 z and norm biases to 0.1 z. The program and
the reference get the same values: the reference calls this again with
the same seed.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

BUCKET = 1 << 26  # elements per draw


def _kind(module: nn.Module, name: str) -> str:
    prefix, leaf = name.rsplit(".", 1)
    sub = module.get_submodule(prefix)
    norm = isinstance(sub, nn.LayerNorm) or type(sub).__name__ == "GroupNorm"
    if leaf == "bias":
        return "norm_bias" if norm else "bias"
    return "norm_weight" if norm else "weight"


def draw(module: nn.Module, gen: torch.Generator, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor of `dtype` on the generator's device} for every
    parameter of `module` (a meta-device module is enough)."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    names = sorted(shapes)
    buckets, current, size = [], [], 0
    for name in names:
        n = int(torch.Size(shapes[name]).numel())
        if current and size + n > BUCKET:
            buckets.append((current, size))
            current, size = [], 0
        current.append(name)
        size += n
    if current:
        buckets.append((current, size))
    out = {}
    for bucket, total in buckets:
        z = torch.randn(total, generator=gen, device=gen.device, dtype=dtype)
        offset = 0
        for name in bucket:
            shape = shapes[name]
            n = int(torch.Size(shape).numel())
            v = z[offset:offset + n].view(shape).float()
            offset += n
            kind = _kind(module, name)
            if kind == "weight":
                v = v * (n // shape[0]) ** -0.5 if len(shape) > 1 else v * 0.02
            elif kind == "bias":
                v = v * 0.02
            elif kind == "norm_weight":
                v = 1.0 + 0.1 * v
            else:
                v = 0.1 * v
            out[name] = v.to(dtype)
        del z
    return out


def materialize(module: nn.Module, tensors: Dict[str, torch.Tensor], device) -> nn.Module:
    """The reference module with `tensors` as its float32 parameters on
    `device`, frozen."""
    module.load_state_dict({k: v.to(device, torch.float32) for k, v in tensors.items()}, strict=True, assign=True)
    return module.eval().requires_grad_(False)

"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel that voxe_tpu's UNet self-attention calls
(`voxe_tpu/models/sd/unet.py:156-171`, JAX's library
`jax.experimental.pallas.ops.tpu.flash_attention.flash_attention`, forward
only): non-causal, unmasked softmax(Q K^T * d^-1/2) V without forming the
[B, h, Q, K] scores. The CUDA source is `voxe_tpu_torch/csrc/flash_attn_fwd.cu`;
it is compiled with nvcc for sm_90a into a shared library with a plain C
interface at first use and loaded with ctypes. The kernel loads and stores
through TMA descriptors that the C entry point encodes on every call
(`encode_us` measures that host cost).

Layout is [B, Q, h, d] (the UNet's own layout before a head transpose), bf16
in and out, d in {64, 128}. A CPU tensor goes to `flash_attention_reference`;
a CUDA tensor goes to the kernel or the call raises — there is no fallback.
`LAUNCHES` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from voxe_tpu_torch.ops.cuda_build import CudaLibrary

SUPPORTED_HEAD_DIMS = (64, 128)

_LIB = CudaLibrary(
    "flash_attn_fwd.cu", "voxe_flash_attn_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
)
LAUNCHES = 0  # kernel launches since import (or the last reset)


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def build(verbose: bool = False):
    """Compile the kernel (once per source content) and return the library
    path. `verbose` prints ptxas' report when a build happens."""
    return _LIB.build(verbose)


def encode_us(q, k, v, out, iters: int = 1000) -> float:
    """Host microseconds to encode one call's four TMA descriptors (the
    average of `iters`; nothing is launched). CUDA tensors as for the kernel."""
    fn = _LIB.symbol_function(
        "voxe_flash_attn_encode_us", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6, ctypes.c_double
    )
    B, Lq, H, D = q.shape
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Lq, k.shape[1], D, iters)
    if us < 0:
        raise RuntimeError("flash_attn_fwd: could not encode the TMA descriptors")
    return us


def flash_attention_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: scores and softmax in f32, output in q's dtype.
    q [B, Q, h, d], k/v [B, K, h, d] -> [B, Q, h, d]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(Q K^T * scale) V over [B, Q, h, d] tensors (default scale
    d^-1/2). CPU tensors take the plain version; CUDA tensors the kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, L, h, d], got {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16 != 0:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
        if x.requires_grad:
            raise ValueError("flash_attention: forward only; no path needs its backward yet")
    B, Lq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    Lk = k.shape[1]
    if Lq == 0 or Lk == 0:
        raise ValueError("flash_attention: empty sequence")
    if not scale > 0.0:
        raise ValueError(f"flash_attention: the kernel takes a positive scale, got {scale}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _LIB.function()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Lq, Lk, D, float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out

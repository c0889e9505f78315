"""Flash attention: the hand-written Hopper kernels, forward and backward,
and their plain PyTorch versions.

Replaces the Pallas TPU kernels that voxe_tpu's UNet self-attention calls
(`voxe_tpu/models/sd/unet.py:156-171`, JAX's library
`jax.experimental.pallas.ops.tpu.flash_attention.flash_attention`):
non-causal, unmasked softmax(Q K^T * d^-1/2) V without forming the
[B, h, Q, K] scores, and its custom VJP (`_flash_attention_bwd`, over the
dK/dV and dQ kernels). The CUDA sources are
`voxe_tpu_torch/csrc/flash_attn_fwd.cu` and `flash_attn_bwd.cu`; each is
compiled with nvcc for sm_90a into a shared library with a plain C interface
at first use and loaded with ctypes. Both load through TMA descriptors that
their C entry points encode on every call (`encode_us` and `encode_us_bwd`
measure that host cost).

Layout is [B, Q, h, d] (the UNet's own layout before a head transpose), bf16
in and out, d in {64, 128}. A CPU tensor goes to `flash_attention_reference`
(autograd differentiates it); a CUDA tensor goes to the kernels or the call
raises — there is no fallback. On the card `flash_attention` is an autograd
function when grad mode is on and an input requires grad: its forward then
also writes the row log-sum-exp ([B, h, Q] f32) that the backward reads, and
its backward launches the backward kernels; otherwise the forward writes no
LSE. The backward is three launches (`backward_kernels`): a preprocess that
computes Di = rowsum(dO * O) and pads Di and the LSE to the query tile, one
pass that computes dK, dV and dQ's partial sums (reduced into an f32
workspace in tile order), and a postprocess that turns the workspace into dq.
`LAUNCHES` counts forward kernel launches that ran, a CUDA graph's replays
included, and `LAUNCHES_BWD` backward calls (one a call, whatever its three
launches), and nothing else; `REFERENCE_ON_CUDA` counts calls of a plain
version on a CUDA tensor, which no path of the port makes (the UNet's other
attention goes to the library's SDPA). All three are program counters
(`voxe_tpu_torch/utils/tracing.py::count`).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from voxe_tpu_torch.ops.cuda_build import CudaLibrary
from voxe_tpu_torch.utils import tracing

SUPPORTED_HEAD_DIMS = (64, 128)

_LIB = CudaLibrary(
    "flash_attn_fwd.cu", "voxe_flash_attn_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
)
_LIB_BWD = CudaLibrary(
    "flash_attn_bwd.cu", "voxe_flash_attn_bwd",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
)
# The backward's query tile by head dim (`Cfg<D>::kBlockM` in flash_attn_bwd.cu,
# which refuses any other): Di, the LSE and the dQ workspace are padded to it.
BWD_Q_TILE = {64: 128, 128: 64}
BWD_DQ_CHUNK = 64  # a tile's dQ workspace holds 64 x 64 chunks, each in the kernel's register order
LAUNCHES = 0  # forward kernel launches that ran since import
# backward calls since import; each is three kernel launches (preprocess,
# main pass, postprocess) and counts once
LAUNCHES_BWD = 0
REFERENCE_ON_CUDA = 0  # plain-version calls on a CUDA tensor since import


def build(verbose: bool = False):
    """Compile the forward kernel (once per source content) and return the
    library path. `verbose` prints ptxas' report when a build happens."""
    return _LIB.build(verbose)


def build_bwd(verbose: bool = False):
    """The same for the backward kernels."""
    return _LIB_BWD.build(verbose)


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


def encode_us_bwd(q, k, v, do, iters: int = 1000) -> float:
    """Host microseconds to encode one backward call's four TMA descriptors
    (q, k, v, dO; the average of `iters`; nothing is launched)."""
    fn = _LIB_BWD.symbol_function(
        "voxe_flash_attn_bwd_encode_us", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6, ctypes.c_double
    )
    B, Lq, H, D = q.shape
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), B, H, Lq, k.shape[1], D, iters)
    if us < 0:
        raise RuntimeError("flash_attn_bwd: could not encode the TMA descriptors")
    return us


def _count_reference(x) -> None:
    if x.device.type == "cuda":
        tracing.count("flash_attention.REFERENCE_ON_CUDA", device=x.device)


def flash_attention_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: scores and softmax in f32, output in q's dtype.
    q [B, Q, h, d], k/v [B, K, h, d] -> [B, Q, h, d]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _count_reference(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_lse_reference(q, k, scale: Optional[float] = None) -> torch.Tensor:
    """Plain row log-sum-exp of the scaled scores, [B, h, Q] f32: the
    residual the forward kernel writes for the backward."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _count_reference(q)
    return torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale, dim=-1)


def flash_attention_backward_reference(q, k, v, o, lse, do, scale: Optional[float] = None):
    """Plain backward in f32, the explicit formula (no autograd): with
    P = exp(Q K^T * scale - lse) and Di = rowsum(dO * O),
    dV = P^T dO, dS = P * (dO V^T - Di), dK = dS^T Q * scale,
    dQ = dS K * scale. q, o, do [B, Q, h, d]; k, v [B, K, h, d]; lse
    [B, h, Q]. Returns (dq, dk, dv) in f32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _count_reference(q)
    q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale - lse.float()[..., None])
    di = torch.einsum("bqhd,bqhd->bhq", do, o)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - di[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    return dq, dk, dv


def _check_inputs(name_tensors, scale: float) -> None:
    """What the kernels take: bf16 [B, L, h, d] CUDA tensors on one device,
    contiguous and 16-byte aligned, d in SUPPORTED_HEAD_DIMS, scale > 0."""
    first = name_tensors[0][1]
    for name, x in name_tensors:
        if x.device != first.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {first.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, L, h, d], got {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16 != 0:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    q, k, v = (t for _, t in name_tensors[:3])
    B, Lq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if Lq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")
    if not scale > 0.0:
        raise ValueError(f"flash_attention: the kernel takes a positive scale, got {scale}")


def _forward_kernel(q, k, v, scale: float, with_lse: bool):
    """One forward launch: (out, lse or None)."""
    _check_inputs((("q", q), ("k", k), ("v", v)), scale)
    B, Lq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _LIB.function()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        B, H, Lq, k.shape[1], D, float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    tracing.count("flash_attention.LAUNCHES", device=q.device)
    return out, lse


def _cuda_device(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_with_lse(q, k, v, scale: Optional[float] = None):
    """(softmax(Q K^T * scale) V, row log-sum-exp [B, h, Q] f32): the
    forward with the residual the backward reads. CPU tensors take the plain
    versions; CUDA tensors one kernel launch."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale), flash_attention_lse_reference(q, k, scale)
    _cuda_device(q)
    return _forward_kernel(q, k, v, scale, with_lse=True)


def flash_attention_bwd_preprocess_reference(o, do, lse, q_tile: int):
    """Plain version of the backward's preprocess kernel: (Di_pad,
    lse_log2_pad), each [B, h, Lq_pad] f32 with Lq_pad = Lq rounded up to
    `q_tile`. Di = rowsum(dO * O) in f32 (as `_flash_attention_bwd` computes
    it) and lse * log2(e); the padding holds Di = 0 and lse = +inf, so
    P = exp2(S * scale * log2(e) - lse * log2(e)) = 0 there. o, do
    [B, Lq, h, d]; lse [B, h, Lq]."""
    _count_reference(o)
    B, Lq, H, _ = o.shape
    pad = -Lq % q_tile
    di = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
    lse2 = lse.float() * math.log2(math.e)
    return (torch.nn.functional.pad(di, (0, pad), value=0.0),
            torch.nn.functional.pad(lse2, (0, pad), value=math.inf))


def flash_attention_dq_postprocess_reference(dq_accum, scale: float, Lq: int) -> torch.Tensor:
    """Plain version of the backward's postprocess kernel: the f32 dQ
    workspace (dS K summed over key blocks, [B, h, Lq_pad, d] in tile order)
    times `scale`, as bf16 [B, Lq, h, d]. Inside a tile of BWD_Q_TILE[d]
    queries, each 64 x 64 chunk (query box, then column box) is in the main
    kernel's register order: float 2 * (128 i + tid) + e holds row
    16 (tid // 32) + (tid % 32) // 4 + 8 (i % 2) and column
    8 (i // 2) + 2 (tid % 4) + e."""
    _count_reference(dq_accum)
    B, H, Lq_pad, D = dq_accum.shape
    M, C = BWD_Q_TILE[D], BWD_DQ_CHUNK
    # [tiles, query box, column box, i // 2, i % 2, warp, row in 8, tid % 4, e]
    x = dq_accum.float().reshape(B, H, Lq_pad // M, M // C, D // C, 8, 2, 4, 8, 4, 2)
    # rows (query box, warp, i % 2, row in 8), columns (column box, i // 2, tid % 4, e)
    x = x.permute(0, 1, 2, 3, 7, 6, 8, 4, 5, 9, 10).reshape(B, H, Lq_pad, D)[:, :, :Lq]
    return (x * scale).permute(0, 2, 1, 3).to(torch.bfloat16)


def flash_attention_backward(q, k, v, o, lse, do, scale: Optional[float] = None):
    """(dq, dk, dv) of softmax(Q K^T * scale) V at the upstream gradient
    `do`, from the forward's inputs, output `o` and row log-sum-exp `lse`.
    CPU tensors take the plain backward (f32 out); CUDA tensors (bf16, as the
    forward; lse f32 [B, h, Q]) the kernels (`backward_kernels`), bf16 out.
    On the card dk and dv are bitwise the same from call to call; dq is not:
    its partial sums over key blocks are added into an f32 workspace in the
    order the blocks finish (as SDPA's backward, it is not bitwise either)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, scale)
    return backward_kernels(q, k, v, o, lse, do, scale)[:3]


def backward_kernels(q, k, v, o, lse, do, scale: float):
    """One backward call on the card: the preprocess, main and postprocess
    kernels. Returns (dq, dk, dv, di_pad, lse_log2_pad, dq_accum): the
    gradients (bf16) and the scratch the kernels wrote ([B, h, Lq_pad] f32
    twice, and the [B, h, Lq_pad, d] f32 workspace in tile order, unscaled),
    which the plain versions of the preprocess and postprocess reproduce."""
    _cuda_device(q)
    _check_inputs((("q", q), ("k", k), ("v", v), ("o", o), ("do", do)), scale)
    B, Lq, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_backward: o{tuple(o.shape)} and do{tuple(do.shape)} must be q's shape")
    if lse.dtype != torch.float32 or lse.shape != (B, H, Lq) or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_backward: lse must be contiguous f32 [B, h, Q] on {q.device}")
    tile = BWD_Q_TILE[D]
    lq_pad = -(-Lq // tile) * tile
    f32 = dict(dtype=torch.float32, device=q.device)
    di, lse2 = torch.empty((B, H, lq_pad), **f32), torch.empty((B, H, lq_pad), **f32)
    dq_accum = torch.empty((B, H, lq_pad, D), **f32)  # zeroed by the preprocess kernel
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _LIB_BWD.function()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        lse2.data_ptr(), dq_accum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Lq, k.shape[1], D, tile, float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: CUDA error {err}")
    tracing.count("flash_attention.LAUNCHES_BWD", device=q.device)
    return dq, dk, dv, di, lse2, dq_accum


class _FlashAttention(torch.autograd.Function):
    """The kernel forward with its LSE residual; the kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(Q K^T * scale) V over [B, Q, h, d] tensors (default scale
    d^-1/2). CPU tensors take the plain version; CUDA tensors the kernel,
    differentiable through the backward kernels when grad mode is on and an
    input requires grad."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _cuda_device(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward_kernel(q, k, v, scale, with_lse=False)[0]

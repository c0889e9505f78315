"""GroupNorm with an optional SiLU after it: the hand-written Hopper kernel,
forward and backward, and its plain PyTorch version.

The statistics are `ReduceFirstGroupNorm`'s (voxe_tpu/models/sd/norms.py):
per-channel first and second moments in f32, folded to group moments,
variance E[x^2] - E[x]^2 clamped at 0, then one affine pass
`y = x * a_c + b_c` with gamma, beta and the mean shift folded into
per-channel a and b, cast to x's dtype; with `silu`, SiLU follows.

The kernel replaces no Pallas kernel: the JAX package leaves this formula to
XLA, which fuses it. Eager PyTorch does not: the plain version is some twenty
launches a call (an f32 copy of the activation, two reductions, a dozen
[B, C] ops, two full-size f32 passes, a cast, the SiLU) and about 48 bytes an
element forward, 70-90 backward, and autograd keeps the f32 copy. The kernel
(`voxe_tpu_torch/csrc/group_norm.cu`) is bound by bytes: about 6 an element
forward (x read twice, y written once, bf16) and 10 backward (x and dy read
twice, dx written once), the compulsory 4 and 6 at 3.35 TB/s. Each direction
is one call of its C entry point, three launches (a partial-sum pass, a
fixed-order fold, an elementwise pass); it saves x and the [B, C] and [B, G]
statistics for the backward, no f32 copy. No float atomics: a call is bitwise
repeatable, so a CUDA graph's replay equals the eager call.

On the card the kernel computes SiLU in f32 before the one rounding to x's
dtype; the plain version rounds the norm's output first, then applies
`F.silu`, as the SD stack did before the kernel (the CPU path keeps that
arithmetic, so the CPU parity tests hold bit for bit).

A CUDA tensor goes to the kernel or the call raises: 4-D, channels_last or
contiguous NCHW, bf16 or f32, gamma and beta bf16 or f32, C / groups <= 256.
Any other device takes the plain version. `LAUNCHES` counts kernel calls that
ran, forward and backward alike, a CUDA graph's replays included, each
`KERNELS_PER_CALL` launches; `REFERENCE_ON_CUDA` counts calls of the plain
version on a CUDA tensor, which no path of the port makes. Both are program
counters (`voxe_tpu_torch/utils/tracing.py::count`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from voxe_tpu_torch.ops.cuda_build import CudaLibrary
from voxe_tpu_torch.utils import tracing

_ARGS = [ctypes.c_int] * 12
_LIB = CudaLibrary(
    "group_norm.cu", "voxe_group_norm_fwd",
    [ctypes.c_void_p] * 6 + _ARGS + [ctypes.c_float, ctypes.c_void_p],
)
_BWD = None  # the backward's C function, loaded at first use

THREADS = 256  # a block of the NHWC pass kernels (kMaxThreads in the source)
ROWS_PER_BLOCK = 8  # NCHW: one warp a (b, c) row (kRowsPerBlock)
BLOCKS_PER_SM = 4  # the passes' grid: about this many blocks on each SM
MAX_CHANNELS_PER_GROUP = 256  # a fold block holds one group (kFoldThreads)
KERNELS_PER_CALL = 3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0  # kernel calls that ran since import; each KERNELS_PER_CALL launches
REFERENCE_ON_CUDA = 0  # plain-version calls on a CUDA tensor since import
_SMS = {}  # device index -> SM count


def build(verbose: bool = False):
    """Compile the kernels (once per source content) and return the library
    path. `verbose` prints ptxas' report when a build happens."""
    return _LIB.build(verbose)


def group_norm_reference(x, weight, bias, num_groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """Plain version over [B, C, ...] in any memory format: f32 statistics,
    output in x's dtype, then `F.silu` when `silu`."""
    if x.device.type == "cuda":
        tracing.count("group_norm.REFERENCE_ON_CUDA", device=x.device)
    B, C = x.shape[:2]
    G = num_groups
    reps = C // G
    spatial = tuple(range(2, x.ndim))
    per_group = float(x[0, 0].numel() * reps)
    xf = x.float()
    s1 = xf.sum(spatial)  # [B, C]
    s2 = (xf * xf).sum(spatial)
    g1 = s1.reshape(B, G, reps).sum(-1) / per_group  # group mean
    g2 = s2.reshape(B, G, reps).sum(-1) / per_group  # E[x^2]
    var = torch.clamp(g2 - g1 * g1, min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(reps, dim=-1) * weight.float()[None]
    b = bias.float()[None] - g1.repeat_interleave(reps, dim=-1) * a
    bshape = (B, C) + (1,) * (x.ndim - 2)
    y = (xf * a.reshape(bshape) + b.reshape(bshape)).to(x.dtype)
    return F.silu(y) if silu else y


def plan(B: int, C: int, HW: int, nhwc: bool, vec: int, sms: int) -> Tuple[int, int, int]:
    """(splits, tc, tp): the launch geometry the kernels take. NHWC: a block
    is tc channel vectors (of `vec` channels) x tp pixel lanes, at most
    THREADS threads, at most 64 vectors wide; NCHW: ROWS_PER_BLOCK rows a
    block (tc = tp = 0). The pixels split into as many parts as bring the
    grid to about BLOCKS_PER_SM blocks an SM, and no more than leave each
    pixel lane (NHWC) or warp (NCHW) one vector."""
    if nhwc:
        nvec = C // vec
        chunks = -(-nvec // 64)
        tc = -(-nvec // chunks)
        tp = THREADS // tc
        across, most = chunks * B, -(-HW // tp)
    else:
        tc = tp = 0
        across, most = -(-B * C // ROWS_PER_BLOCK), -(-HW // (32 * vec))
    splits = max(1, min(most, -(-BLOCKS_PER_SM * sms // across)))
    return splits, tc, tp


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _layout(x: torch.Tensor) -> bool:
    """True for channels_last, False for contiguous NCHW; raises otherwise."""
    if x.is_contiguous():
        return False
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    raise ValueError("group_norm kernel: x must be channels_last or contiguous NCHW")


def _check(x, weight, bias, num_groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"group_norm kernel: x must be 4-D [B, C, H, W], got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"group_norm kernel: x on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"group_norm kernel: x must be float32 or bfloat16, got {x.dtype}")
    B, C, H, W = x.shape
    if min(B, C, H, W) == 0:
        raise ValueError("group_norm kernel: empty input")
    if C % num_groups != 0 or C // num_groups > MAX_CHANNELS_PER_GROUP:
        raise ValueError(f"group_norm kernel: {C} channels in {num_groups} groups "
                         f"(at most {MAX_CHANNELS_PER_GROUP} a group)")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.device != x.device or p.dtype not in _DTYPES or p.shape != (C,) or not p.is_contiguous():
            raise ValueError(f"group_norm kernel: {name} must be contiguous [{C}] float32 or bfloat16 on {x.device}")
    if weight.dtype != bias.dtype:
        raise ValueError("group_norm kernel: weight and bias must share a dtype")


def _vec(nhwc: bool, x: torch.Tensor, *tensors: torch.Tensor) -> int:
    """16-byte vectors where the contiguous dimension and every pointer
    allow them, else single elements."""
    vec = 16 // x.element_size()
    inner = x.shape[1] if nhwc else x.shape[2] * x.shape[3]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + tensors)
    return vec if inner % vec == 0 and aligned else 1


def forward_kernel(x, weight, bias, num_groups: int, eps: float, silu: bool = False):
    """One forward call on the card: (y, aux), aux the f32 [2 B C + 3 B G]
    statistics the backward reads (a [B, C], b [B, C], then per (b, group)
    mean, rstd and the unclamped E[x^2] - mean^2)."""
    _check(x, weight, bias, num_groups)
    nhwc = _layout(x)
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    vec = _vec(nhwc, x, y)
    S, tc, tp = plan(B, C, H * W, nhwc, vec, _sms(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    aux = torch.empty(2 * B * C + 3 * B * num_groups, **f32)
    partial = torch.empty(2 * S * B * C, **f32)
    err = _LIB.function()(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), aux.data_ptr(), partial.data_ptr(),
        B, C, H * W, num_groups, S, tc, tp, int(nhwc), _DTYPES[x.dtype], _DTYPES[weight.dtype], vec, int(silu),
        float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"group_norm forward launch failed: CUDA error {err}")
    tracing.count("group_norm.LAUNCHES", device=x.device)
    return y, aux


def backward_kernel(x, dy, weight, aux, num_groups: int, silu: bool = False):
    """One backward call on the card at the upstream gradient `dy`, from the
    forward's input and `aux`: (dx in x's dtype, dgamma, dbeta in weight's)."""
    global _BWD
    nhwc = _layout(x)
    B, C, H, W = x.shape
    dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last if nhwc else torch.contiguous_format)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"group_norm backward: dy{tuple(dy.shape)} must be x's shape on {x.device}")
    dx = torch.empty_like(x)
    vec = _vec(nhwc, x, dy, dx)
    S, tc, tp = plan(B, C, H * W, nhwc, vec, _sms(x.device))
    dparams = torch.empty((2, C), dtype=weight.dtype, device=x.device)
    scratch = torch.empty(2 * B * num_groups + 2 * S * B * C, dtype=torch.float32, device=x.device)
    if _BWD is None:
        _BWD = _LIB.symbol_function(
            "voxe_group_norm_bwd", [ctypes.c_void_p] * 8 + _ARGS + [ctypes.c_void_p], ctypes.c_int
        )
    err = _BWD(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), aux.data_ptr(), dx.data_ptr(), dparams[0].data_ptr(),
        dparams[1].data_ptr(), scratch.data_ptr(), B, C, H * W, num_groups, S, tc, tp, int(nhwc),
        _DTYPES[x.dtype], _DTYPES[weight.dtype], vec, int(silu), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"group_norm backward launch failed: CUDA error {err}")
    tracing.count("group_norm.LAUNCHES", device=x.device)
    return dx, dparams[0], dparams[1]


class _GroupNorm(torch.autograd.Function):
    """The kernel forward, saving x and its statistics; the kernel backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        y, aux = forward_kernel(x, weight, bias, num_groups, eps, silu)
        ctx.save_for_backward(x, weight, aux)
        ctx.num_groups, ctx.silu = num_groups, silu
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, aux = ctx.saved_tensors
        grads = backward_kernel(x, dy, weight, aux, ctx.num_groups, ctx.silu)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad)) + (None, None, None)


def group_norm(x, weight, bias, num_groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over [B, C, ...] (then SiLU when `silu`). CUDA tensors take
    the kernel, differentiable through the backward kernel when grad mode is
    on and an input requires grad; other devices the plain version."""
    if x.device.type != "cuda":
        return group_norm_reference(x, weight, bias, num_groups, eps, silu)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _GroupNorm.apply(x, weight, bias, num_groups, eps, silu)
    return forward_kernel(x, weight, bias, num_groups, eps, silu)[0]

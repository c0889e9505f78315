"""Rounding of the reference's matrix-product inputs.

The reference computes in float32 with TF32 off. The control that proves
the correctness check can fail is the same reference with every input of a
product that the configuration runs in bfloat16 (the SD weights and
activations, the grid's resample table) rounded to float8 e4m3 with one
scale per tensor, the next precision below bfloat16: a product's inputs in
the forward, and (`Rounding.grads`) the gradient a product's backward takes
in, as a bfloat16 backward rounds it.
"""
from __future__ import annotations

import functools

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    scale = FP8_MAX / xf.abs().amax().clamp(min=1e-30)
    return (xf * scale).to(torch.float8_e4m3fn).float() / scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


_ROUND = {"fp8": _round_fp8, "bf16": _round_bf16}


class _RoundForward(torch.autograd.Function):
    """Rounded values forward; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, kind):
        return _ROUND[kind](x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundBackward(torch.autograd.Function):
    """Values unchanged forward; the incoming gradient rounded."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ROUND[ctx.kind](g), None


class Rounding:
    """`Rounding("f32")` leaves values alone; `Rounding("fp8")` rounds them
    to float8 e4m3 (per-tensor scale), the control's step below bfloat16;
    `Rounding("bf16")` to bfloat16, its step below float32."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8", "bf16"):
            raise ValueError(f"rounding {kind!r}: 'f32', 'fp8' or 'bf16'")
        self.kind = kind

    def below(self, dtype: str) -> "Rounding":
        """The rounding of a part the configuration runs in `dtype`: none in
        the reference; in the control, one step below that dtype."""
        if self.kind == "f32":
            return self
        return Rounding("fp8" if dtype == "bfloat16" else "bf16")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A product's input, rounded."""
        return x if self.kind == "f32" else _RoundForward.apply(x, self.kind)

    def grads(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output, whose gradient is rounded on its way back."""
        return _RoundBackward.apply(y, self.kind) if self.kind != "f32" and y.requires_grad else y


def precise(fn):
    """`fn` with float32 products kept in float32 on the card (TF32 off),
    the library's settings restored after it."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return wrapped

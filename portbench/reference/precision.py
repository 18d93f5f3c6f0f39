"""Matrix products at a named precision, and the float32 switches."""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 after scaling its absolute maximum to
    the format's largest value (per-tensor scaling, as fp8 training
    does), then scaled back; float32 out."""

    xf = x.float()
    amax = xf.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (xf * scale).to(torch.float8_e4m3fn).float() / scale


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x.float()
    if precision == "fp8":
        return round_fp8(x)
    raise ValueError(f"unknown precision {precision!r}")


class _RoundFp8(torch.autograd.Function):
    """fp8 rounding in the forward and in the backward (the gradient of a
    product's operand is itself a product's output, rounded for the next
    product as an fp8 path would)."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 with both operands at ``precision``."""

    if precision == "fp32":
        return a.float() @ b.float()
    if precision == "fp8":
        return _RoundFp8.apply(a.float()) @ _RoundFp8.apply(b.float())
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def strict_fp32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN while
    the reference runs, the previous switches restored after."""

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])

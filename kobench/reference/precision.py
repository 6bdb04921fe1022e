"""The products of the plain references, at the precision a check asks
for.

* ``f32``: float32 operands and result, TF32 off.
* ``fp8``: the control one step below bfloat16. Each operand is scaled
  per tensor to the range of float8 e4m3 and rounded to it; in backward the
  incoming gradient is rounded to float8 e5m2 before the two gradient
  products, as fp8 training does. Products accumulate in float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Operand(torch.autograd.Function):
    """e4m3 in forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GradOperand(torch.autograd.Function):
    """Identity in forward; the gradient is rounded to e5m2 in backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad, torch.float8_e5m2, E5M2_MAX)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _GradOperand.apply(torch.matmul(_Operand.apply(a),
                                           _Operand.apply(b)))


PRODUCTS = {"f32": _mm_f32, "fp8": _mm_fp8}


def product(mode: str):
    """The matmul of precision `mode`; sets TF32 off for float32."""
    if mode not in PRODUCTS:
        raise ValueError(f"unknown reference precision {mode!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return PRODUCTS[mode]

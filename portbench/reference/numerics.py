"""Matrix products of the reference in its precision.

``fp32``: plain fp32 products, TF32 off.  ``fp8``: the control; both
operands of every product are rounded to float8 e4m3 with one scale per
tensor (its largest magnitude to 448, e4m3's largest finite value), then
multiplied in fp32.  The rounding passes gradients straight through, so
the backward's products take the rounded operands that autograd saved.
"""
from __future__ import annotations

import torch

PRECISIONS = ("fp32", "fp8")
_E4M3_MAX = 448.0


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Numerics:
    def __init__(self, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(x) if self.precision == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self.round(a), self.round(b))

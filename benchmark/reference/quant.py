"""The control's lower precision: each operand of a conv or matmul
rounded to fp8 (e4m3, scaled per tensor to its largest magnitude) in the
forward, and the gradient that reaches it rounded to e5m2 in the backward,
as fp8 training rounds them. The arithmetic around the rounding stays f32."""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)

"""The lower-precision control: the reference with every tensor that the
program stores in its compute dtype rounded to 8-bit floats, as an fp8
training recipe does: per-tensor scaled e4m3 in the forward, scaled e5m2
for the cotangents in the backward.

It is the step below bfloat16 that a later change could be tempted to
take; ``correct`` has to come out false for it.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / top
    return ((x / scale).to(dtype).to(x.dtype)) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to scaled e4m3; its cotangent rounded to scaled e5m2."""
    return _Fp8.apply(x)

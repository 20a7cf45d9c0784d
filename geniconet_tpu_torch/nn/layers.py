"""Icosahedral conv, eval-mode BatchNorm and the residual blocks.

Port of ``geniconet_tpu/nn/layers.py`` (eval mode), following its fused
route (``use_pallas=True``), which the JAX package pins to its XLA route in
tests/test_model_pallas_parity.py:

* DownBlock: both stride-2 convs in one phase-conv call (output phase 2,
  already level s-1), with the pending BN-apply + ReLU of the layer before as
  the act prologue; conv01 as the standard-layout conv with bn00 as its
  prologue; the residual join relu(bn01(b0) + bn10(y10)) in float32.
* UpBlock: upsample + conv00 + conv10 in one call (4 phases of level s+1
  each), conv01 as a phase conv with bn00 as its prologue, then the join and
  one interleave — or, with ``return_phases``, the raw phases and the two
  pending affines for the decoder's fused head.

Every conv goes through a wrapper in ``ops/kernels``, which launches the
CUDA kernel for CUDA tensors and runs the plain PyTorch version for CPU
tensors. Parameters stay float32; each call casts them to the activation
dtype. Parameter names and shapes follow the flax tree (see ``bridge.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from geniconet_tpu_torch.ops.kernels.conv_kernel import ico_conv_s2s_fwd
from geniconet_tpu_torch.ops.kernels.phase_kernel import phase_conv_fwd, up_dual_conv_fwd
from geniconet_tpu_torch.ops.phase import phase_merge, phase_split

__all__ = ["IcoConvS2S", "IcoBatchNorm", "DownBlock", "UpBlock", "residual_join"]


class IcoConvS2S(nn.Module):
    """Hexagonal icosahedral conv (reference IcoConvS2S contract): taps
    (7, C_in, C_out) and bias (C_out,), initialised U(±1/sqrt(7·C_in)) like
    the JAX package (the hex conv's true fan-in). ``forward`` is the
    stride-1 conv; the blocks hand ``params`` of their stride-2 convs to the
    fused phase conv."""

    def __init__(self, in_features: int, features: int, corner_mode: str = "average",
                 device=None):
        super().__init__()
        self.corner_mode = corner_mode
        bound = 1.0 / (7 * in_features) ** 0.5
        self.taps = nn.Parameter(
            torch.empty(7, in_features, features, device=device).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(features, device=device).uniform_(-bound, bound))

    def params(self, dtype: torch.dtype):
        """(taps, bias) cast to the activation dtype, for the fused calls."""
        return self.taps.to(dtype), self.bias.to(dtype)

    def forward(self, x: torch.Tensor, act=None) -> torch.Tensor:
        """(B, 5, h, w, C_in) -> (B, 5, h, w, C_out), stride 1; act: optional
        float32 (mul, add) prologue relu(x·mul + add)."""
        taps, bias = self.params(x.dtype)
        return ico_conv_s2s_fwd(x.contiguous(), taps, bias, self.corner_mode, act)


class IcoBatchNorm(nn.Module):
    """Eval-mode BatchNorm over the channel axis: float32 ``scale``/``bias``
    parameters and ``mean``/``var`` running statistics (eps 1e-5). It yields
    the per-channel affine (mul, add) that the next kernel applies as its
    prologue (``layers.py:_StatsBN`` of the JAX package)."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def affine(self):
        """(mul, add), float32: mul = rsqrt(var + eps)·scale, add = bias − mean·mul."""
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        return mul, self.bias - self.mean * mul


def residual_join(a: torch.Tensor, b: torch.Tensor, aff1, aff2) -> torch.Tensor:
    """relu(a·mul1 + add1 + b·mul2 + add2) in float32, cast to a's dtype."""
    (mul1, add1), (mul2, add2) = aff1, aff2
    return torch.clamp_min(a.float() * mul1 + add1 + b.float() * mul2 + add2, 0.0).to(a.dtype)


class DownBlock(nn.Module):
    """Residual down block (reference BasicIcoS2SDownBlock), s -> s-1:
    relu(bn01(conv01(relu(bn00(conv00(x))))) + bn10(conv10(x)))."""

    def __init__(self, in_features: int, features: int, corner_mode: str = "average",
                 device=None):
        super().__init__()
        kw = dict(corner_mode=corner_mode, device=device)
        self.corner_mode = corner_mode
        self.conv00 = IcoConvS2S(in_features, features, **kw)  # stride 2
        self.conv10 = IcoConvS2S(in_features, features, **kw)  # stride 2
        self.conv01 = IcoConvS2S(features, features, **kw)
        self.bn00 = IcoBatchNorm(features, device=device)
        self.bn01 = IcoBatchNorm(features, device=device)
        self.bn10 = IcoBatchNorm(features, device=device)

    def forward(self, x, in_act=None) -> torch.Tensor:
        """x: a (B, 5, H, W, C) grid or its 4 parity phases; in_act: the
        pending (mul, add) BN-apply + ReLU of the producing layer."""
        phases = x if isinstance(x, (tuple, list)) else phase_split(x)
        phases = tuple(p.contiguous() for p in phases)
        dt = phases[0].dtype
        (y00,), (y10,) = phase_conv_fwd(
            phases, [self.conv00.params(dt), self.conv10.params(dt)], self.corner_mode,
            (2,), in_act)
        b0 = self.conv01(y00, act=self.bn00.affine())
        return residual_join(b0, y10, self.bn01.affine(), self.bn10.affine())


class UpBlock(nn.Module):
    """Residual up block (reference BasicIcoS2SUpBlock), s -> s+1. The
    parameter-free upsample is shared by both branches."""

    def __init__(self, in_features: int, features: int, corner_mode: str = "average",
                 return_phases: bool = False, device=None):
        super().__init__()
        kw = dict(corner_mode=corner_mode, device=device)
        self.corner_mode, self.return_phases = corner_mode, return_phases
        self.conv00 = IcoConvS2S(in_features, features, **kw)
        self.conv10 = IcoConvS2S(in_features, features, **kw)
        self.conv01 = IcoConvS2S(features, features, **kw)
        self.bn00 = IcoBatchNorm(features, device=device)
        self.bn01 = IcoBatchNorm(features, device=device)
        self.bn10 = IcoBatchNorm(features, device=device)

    def forward(self, x: torch.Tensor):
        """(B, 5, h, w, C) level-s grid -> (B, 5, 2h, 2w, F) level s+1; with
        ``return_phases``, (b0 phases, y10 phases, (mul01, add01, mul10,
        add10)) for the fused head instead."""
        x = x.contiguous()
        dt = x.dtype
        y00, y10 = up_dual_conv_fwd(
            x, [self.conv00.params(dt), self.conv10.params(dt)], self.corner_mode)
        (b0,) = phase_conv_fwd(y00, [self.conv01.params(dt)], self.corner_mode,
                               act=self.bn00.affine())
        aff01, aff10 = self.bn01.affine(), self.bn10.affine()
        if self.return_phases:
            return b0, y10, (*aff01, *aff10)
        return phase_merge(tuple(residual_join(a, b, aff01, aff10) for a, b in zip(b0, y10)))

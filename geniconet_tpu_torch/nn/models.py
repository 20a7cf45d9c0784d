"""The icosahedral autoencoder (IcoAE, reference ico2ico), eval mode.

Port of ``geniconet_tpu/nn/models.py`` (``_Encoder``, ``_Decoder``,
``_Head``, ``IcoAE``) along the fused route of the JAX package:

  encoder: conv_in (3 -> w0, phase form) ; bn_in as down0's act prologue ;
           Down(w0 -> w1) ; Down(w1 -> w2) ; Down(w2 -> w2)
  decoder: Up(w2 -> w2) ; Up(w2 -> w1) ; Up(w1 -> w0) ; the last block's
           join + 1×1 head (w0 -> 3) + tanh in one fused call

Public tensors: grid ``(B, 5·2^s, 2^(s+1), 3)``; latent
``(B, 5·2^(s-3), 2^(s-2), w2)``. ``decode`` returns float32.
"""

from __future__ import annotations

import torch
from torch import nn

from geniconet_tpu_torch.nn.layers import DownBlock, IcoBatchNorm, IcoConvS2S, UpBlock
from geniconet_tpu_torch.ops.conv import merge_charts, split_charts
from geniconet_tpu_torch.ops.kernels.phase_kernel import pair_head_fwd, phase_conv_fwd
from geniconet_tpu_torch.ops.phase import phase_merge, phase_split

__all__ = ["IcoAE"]


class _Encoder(nn.Module):
    def __init__(self, widths, corner_mode: str, device=None):
        super().__init__()
        w0 = widths[0]
        self.corner_mode = corner_mode
        self.conv_in = IcoConvS2S(3, w0, corner_mode=corner_mode, device=device)
        self.bn_in = IcoBatchNorm(w0, device=device)
        for k, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"down{k}", DownBlock(cin, cout, corner_mode, device=device))
        self.n_down = len(widths) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 5, h, w, 3) chart-split grid -> (B, 5, h/8, w/8, w2)."""
        phases = tuple(p.contiguous() for p in phase_split(x))
        (y,) = phase_conv_fwd(phases, [self.conv_in.params(x.dtype)], self.corner_mode)
        in_act = self.bn_in.affine()
        for k in range(self.n_down):
            y = getattr(self, f"down{k}")(y, in_act=in_act if k == 0 else None)
        return y


class _Head(nn.Module):
    """The 1×1 conv head: kernel (fan_in, F), bias (F,), U(±1/sqrt(fan_in))."""

    def __init__(self, fan_in: int, features: int, device=None):
        super().__init__()
        bound = 1.0 / fan_in**0.5
        self.kernel = nn.Parameter(
            torch.empty(fan_in, features, device=device).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(features, device=device).uniform_(-bound, bound))


class _Decoder(nn.Module):
    def __init__(self, widths, in_features: int, out_features: int, corner_mode: str,
                 device=None):
        super().__init__()
        cins = (in_features, *widths[:-1])
        for k, (cin, cout) in enumerate(zip(cins, widths)):
            self.add_module(f"up{k}", UpBlock(cin, cout, corner_mode,
                                              return_phases=k == len(widths) - 1,
                                              device=device))
        self.n_up = len(widths)
        self.head = _Head(widths[-1], out_features, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, 5, hz, wz, C) -> (B, 5, 8hz, 8wz, out_features) float32."""
        x = z
        for k in range(self.n_up):
            x = getattr(self, f"up{k}")(x)
        b0, y10, affines = x
        dt = b0[0].dtype
        outs = pair_head_fwd(b0, y10, affines, self.head.kernel.to(dt), self.head.bias.to(dt))
        return phase_merge(outs)


class IcoAE(nn.Module):
    """Deterministic icosahedral autoencoder (reference ico2ico), eval mode.

    ``dtype`` is the activation (compute) dtype, float32 or bfloat16;
    parameters stay float32. Sums run in float32 inside every conv."""

    def __init__(self, subdivisions: int = 5, widths=(64, 128, 256),
                 corner_mode: str = "average", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if subdivisions < 3:
            raise ValueError("IcoAE needs subdivisions >= 3 (three stride-2 stages)")
        w0, w1, w2 = widths
        self.subdivisions, self.dtype = subdivisions, dtype
        self.encoder = _Encoder((w0, w1, w2, w2), corner_mode, device=device)
        self.decoder = _Decoder((w2, w1, w0), w2, 3, corner_mode, device=device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """grid (B, 5·2^s, 2^(s+1), 3) -> latent (B, 5·2^(s-3), 2^(s-2), w2), in ``dtype``."""
        return merge_charts(self.encoder(split_charts(x.to(self.dtype), self.subdivisions)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latent -> grid (B, 5·2^s, 2^(s+1), 3), float32."""
        return merge_charts(self.decoder(split_charts(z.to(self.dtype), self.subdivisions - 3)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))

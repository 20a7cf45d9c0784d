"""Icosahedral conv, BatchNorm and the residual blocks, in eval and train mode.

Port of ``geniconet_tpu/nn/layers.py``. Each block runs one of the JAX
package's two routes, chosen when the model is built (``fused``, from the
model's ``pallas_blocks`` attribute through ``pallas_block_enabled``):

* fused (``use_pallas=True`` in JAX):
  - DownBlock: both stride-2 convs in one phase-conv call (output phase 2,
    already level s-1), with the pending BN-apply + ReLU of the layer before
    as the act prologue; conv01 as the standard-layout conv with bn00 as
    its prologue; the residual join relu(bn01(b0) + bn10(y10)) in float32.
  - UpBlock: upsample + conv00 + conv10 in one call (4 phases of level s+1
    each), conv01 as a phase conv with bn00 as its prologue, then the join
    and one interleave — or, with ``return_phases``, the raw phases and the
    two pending affines for the decoder's head.
  In train mode the kernels emit the BatchNorm sums [Σy, Σy²], the
  BatchNorms take their batch statistics from them, and the custom VJPs of
  ``ops/kernels/fused.py`` run the backward kernels.
* plain (the JAX XLA route): ``ops/conv.py:ico_conv_s2s`` per conv and
  ``IcoBatchNorm`` applied to the grid (flax ``nn.BatchNorm``), with
  PyTorch's autograd for the backward.

On the fused route the model option ``merged_bwd`` (``merged_bwd_enabled``)
picks, per kernel family, the merged one-pass backward kernels over the
split dx + dtaps pair: ``ds2`` (a DownBlock's stride-2 pair), ``std`` (its
conv01), ``upd`` (an UpBlock's upsample + pair) and ``pcs1`` (its conv01).

Every fused conv goes through a wrapper in ``ops/kernels``, which launches
the CUDA kernel for CUDA tensors and runs the plain PyTorch version for CPU
tensors. Parameters stay float32; each call casts them to the activation
dtype. Parameter names and shapes follow the flax tree (see ``bridge.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from geniconet_tpu_torch.ops.conv import ico_conv_s2s
from geniconet_tpu_torch.ops.kernels.build import act_apply, grid_level
from geniconet_tpu_torch.ops.kernels.fused import (
    fused_dual_s2_conv, fused_ico_conv_s2s, fused_phase_conv_s1, fused_up_dual_conv,
)
from geniconet_tpu_torch.ops.phase import phase_merge, phase_split
from geniconet_tpu_torch.ops.upsample import ico_upsample_s2s

__all__ = ["IcoConvS2S", "IcoBatchNorm", "DownBlock", "UpBlock", "residual_join",
           "pallas_block_enabled", "merged_bwd_enabled"]


def pallas_block_enabled(name: str, pallas_blocks: str | None) -> bool:
    """The JAX package's per-block routing, as a model attribute: with
    ``pallas_blocks`` None every block takes the fused route, otherwise only
    the blocks named in the comma list (e.g. ``"up0,up1,up2"``)."""
    if not pallas_blocks:
        return True
    return name in {s.strip() for s in pallas_blocks.split(",")}


def merged_bwd_enabled(family: str, merged_bwd: str | None) -> bool:
    """The JAX package's ``GENICONET_MERGED_BWD`` routing as a model option:
    None, "" or "0" is off (the split dx + dtaps kernels), "1" or "all"
    merges every family, and a comma list merges the families it names
    (``pcs1``, ``ds2``, ``upd``, ``std``)."""
    if merged_bwd in (None, "", "0"):
        return False
    if merged_bwd in ("1", "all"):
        return True
    return family in {f.strip() for f in merged_bwd.split(",")}


class IcoConvS2S(nn.Module):
    """Hexagonal icosahedral conv (reference IcoConvS2S contract): taps
    (7, C_in, C_out) and bias (C_out,), initialised U(±1/sqrt(7·C_in)) like
    the JAX package (the hex conv's true fan-in). ``forward`` is the fused
    stride-1 conv (``fused_ico_conv_s2s``, trainable), ``plain`` the plain
    route of either stride; the blocks hand ``params`` of their other fused
    convs to the fused kernels."""

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

    def forward(self, x: torch.Tensor, act=None, with_stats: bool = False,
                merged_bwd: bool = False):
        """(B, 5, h, w, C_in) -> (B, 5, h, w, C_out), stride 1; act: optional
        float32 (mul, add) prologue relu(x·mul + add); with_stats: also the
        (2, C_out) float32 [Σy, Σy²] of the output; merged_bwd: the backward
        as one merged kernel."""
        taps, bias = self.params(x.dtype)
        return fused_ico_conv_s2s(x, taps, bias, grid_level(x.shape[2], x.shape[3]),
                                  self.corner_mode, act=act, with_stats=with_stats,
                                  merged_bwd=merged_bwd)

    def plain(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """The plain route (``ico_pad`` + masked 3×3 conv, float32 sums),
        differentiable by autograd: (B, 5, h, w, C_in) -> level s or s-1."""
        taps, bias = self.params(x.dtype)
        return ico_conv_s2s(x, taps, bias, grid_level(x.shape[2], x.shape[3]), stride,
                            self.corner_mode)


class IcoBatchNorm(nn.Module):
    """BatchNorm over the channel axis: float32 ``scale``/``bias`` parameters
    and ``mean``/``var`` running statistics (eps 1e-5, flax momentum 0.9 on
    the biased variance, which is torch's momentum 0.1).

    ``affine`` gives the per-channel (mul, add) that the next kernel applies
    as its prologue (``layers.py:_StatsBN`` of the JAX package); in train
    mode from kernel-emitted [Σy, Σy²]. ``forward`` applies flax's
    ``nn.BatchNorm`` (``use_fast_variance``) to a grid on the plain route."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    @torch.no_grad()
    def _update(self, mean, var):
        self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
        self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)

    def _moments(self, mean, mean2, train):
        if not train:
            return self.mean, self.var
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        self._update(mean, var)
        return mean, var

    def affine(self, stats=None, count=None, train: bool = False):
        """(mul, add), float32: mul = rsqrt(var + eps)·scale, add = bias −
        mean·mul. Eval: the running statistics. Train: mean = Σy/count and
        var = max(0, Σy²/count − mean²) from stats = [Σy, Σy²] (2, C) over
        ``count`` positions, and the running statistics move."""
        if train:
            mean, var = self._moments(stats[0] / count, stats[1] / count, True)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return mul, self.bias - mean * mul

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Normalise a (B, 5, h, w, C) grid in float32, cast back to its dtype."""
        x32 = x.float()
        dims = tuple(range(x.dim() - 1))
        mean, var = self._moments(x32.mean(dim=dims) if train else None,
                                  x32.square().mean(dim=dims) if train else None, train)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean) * mul + self.bias).to(x.dtype)


def residual_join(a: torch.Tensor, b: torch.Tensor, aff1, aff2) -> torch.Tensor:
    """relu(a·mul1 + add1 + b·mul2 + add2) in float32, cast to a's dtype."""
    (mul1, add1), (mul2, add2) = aff1, aff2
    return torch.clamp_min(a.float() * mul1 + add1 + b.float() * mul2 + add2, 0.0).to(a.dtype)


class _Block(nn.Module):
    """The six modules of a residual block (reference BasicIcoS2S*Block)."""

    def __init__(self, in_features, features, corner_mode, fused, merged_bwd, device):
        super().__init__()
        kw = dict(corner_mode=corner_mode, device=device)
        self.corner_mode, self.fused, self.merged_bwd = corner_mode, fused, merged_bwd
        self.conv00 = IcoConvS2S(in_features, features, **kw)
        self.conv10 = IcoConvS2S(in_features, features, **kw)
        self.conv01 = IcoConvS2S(features, features, **kw)
        self.bn00 = IcoBatchNorm(features, device=device)
        self.bn01 = IcoBatchNorm(features, device=device)
        self.bn10 = IcoBatchNorm(features, device=device)

    def _plain_tail(self, x, stride, train):
        """relu(bn01(conv01(relu(bn00(conv00(x))))) + bn10(conv10(x))) on the
        plain route; conv00 and conv10 share x (the JAX route's shared pad)."""
        b0 = torch.relu(self.bn00(self.conv00.plain(x, stride), train))
        b0 = self.bn01(self.conv01.plain(b0), train)
        return torch.relu(b0 + self.bn10(self.conv10.plain(x, stride), train))


class DownBlock(_Block):
    """Residual down block (reference BasicIcoS2SDownBlock), s -> s-1:
    relu(bn01(conv01(relu(bn00(conv00(x))))) + bn10(conv10(x)))."""

    def __init__(self, in_features: int, features: int, corner_mode: str = "average",
                 fused: bool = True, merged_bwd: str | None = None, device=None):
        super().__init__(in_features, features, corner_mode, fused, merged_bwd, device)

    def forward(self, x, in_act=None, train: bool = False) -> torch.Tensor:
        """x: a (B, 5, H, W, C) grid or its 4 parity phases; in_act: the
        pending (mul, add) BN-apply + ReLU of the producing layer."""
        if not self.fused:
            xd = phase_merge(x) if isinstance(x, (tuple, list)) else x
            return self._plain_tail(act_apply(xd, in_act), 2, train)
        phases = x if isinstance(x, (tuple, list)) else phase_split(x)
        phases = tuple(p.contiguous() for p in phases)
        dt = phases[0].dtype
        r = fused_dual_s2_conv(phases, *self.conv00.params(dt), *self.conv10.params(dt),
                               self.corner_mode, act=in_act, with_stats=train,
                               merged_bwd=merged_bwd_enabled("ds2", self.merged_bwd))
        y00, y10 = r[:2]
        s00, s10 = r[2:] if train else (None, None)
        count = float(y00.shape[:-1].numel())
        r = self.conv01(y00, act=self.bn00.affine(s00, count, train), with_stats=train,
                        merged_bwd=merged_bwd_enabled("std", self.merged_bwd))
        b0, s01 = r if train else (r, None)
        return residual_join(b0, y10, self.bn01.affine(s01, count, train),
                             self.bn10.affine(s10, count, train))


class UpBlock(_Block):
    """Residual up block (reference BasicIcoS2SUpBlock), s -> s+1. The
    parameter-free upsample is shared by both branches."""

    def __init__(self, in_features: int, features: int, corner_mode: str = "average",
                 return_phases: bool = False, fused: bool = True, merged_bwd: str | None = None,
                 device=None):
        super().__init__(in_features, features, corner_mode, fused, merged_bwd, device)
        self.return_phases = return_phases

    def forward(self, x: torch.Tensor, train: bool = False):
        """(B, 5, h, w, C) level-s grid -> (B, 5, 2h, 2w, F) level s+1; on the
        fused route with ``return_phases``, (b0 phases, y10 phases, (mul01,
        add01, mul10, add10)) for the decoder's head instead."""
        if not self.fused:
            up = ico_upsample_s2s(x, grid_level(x.shape[2], x.shape[3]), self.corner_mode)
            return self._plain_tail(up, 1, train)
        x = x.contiguous()
        dt = x.dtype
        r = fused_up_dual_conv(x, *self.conv00.params(dt), *self.conv10.params(dt),
                               self.corner_mode, with_stats=train,
                               merged_bwd=merged_bwd_enabled("upd", self.merged_bwd))
        y00, y10 = r[:2]
        s00, s10 = r[2:] if train else (None, None)
        count = 4.0 * y00[0].shape[:-1].numel()
        act00 = self.bn00.affine(s00, count, train)
        r = fused_phase_conv_s1(y00, *self.conv01.params(dt), self.corner_mode, act=act00,
                                with_stats=train,
                                merged_bwd=merged_bwd_enabled("pcs1", self.merged_bwd))
        b0, s01 = r if train else (r, None)
        aff01 = self.bn01.affine(s01, count, train)
        aff10 = self.bn10.affine(s10, count, train)
        if self.return_phases:
            return b0, y10, (*aff01, *aff10)
        return phase_merge(tuple(residual_join(a, b, aff01, aff10) for a, b in zip(b0, y10)))

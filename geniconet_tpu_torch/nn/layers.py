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
The option ``kernel_geff`` (``kernel_geff_enabled``) picks, per kernel
family, whether the split route folds the stats cotangent inside the
kernels or before them (kernel l); the blocks pass their name as the
stride-1 convs' ``fold_site`` and ``fold_ok`` (the model's ``pallas_blocks``
is None), as in JAX.

The DownBlock's phase chain (``phase_chain``, the JAX package's
``GENICONET_PHASE_CHAIN=enc``, ``layers.py:339-386``): the stride-2 pair
runs as ``fused_dual_s2_conv_split`` (kernel m), whose outputs are the
level-(s-1) phases; conv01 runs on them as the phase conv, the residual
join per phase, and the block returns the phase tuple, which the next
DownBlock takes as it is. It needs a level-(s-1) grid with parity phases:
the block takes it from input level 2 up, as JAX's ``s >= 2`` gate.

The UpBlock's phase chain (``GENICONET_PHASE_CHAIN=dec``, ``layers.py:
513-520, 582-592, 636-645``): an UpBlock may take the previous block's
``(b0 phases, y10 phases, affines)`` in place of a grid. On the fused route
its upsample + pair runs as ``fused_up_dual_conv_pair`` (kernel n), whose
prologue is the previous block's residual join (no merged branch, as in
JAX); on the plain route the pair is joined per phase and interleaved
first. The decoder decides which blocks return phases.

The merged blocks (``merged_block``, ``merged_block_enabled``; the JAX
package's ``GENICONET_MERGED_BLOCK``, ``layers.py:387-422, 540-581``): in
training, a fused DownBlock or UpBlock named by the option runs its whole
forward as one kernel (``fused_down_block``, kernel p; ``fused_up_block``,
kernel o), which computes bn00's affine from its own batch moments and
takes bn00's raw scale and bias (``IcoBatchNorm.kernel_affine``). As in
JAX, the encoder's chain comes first (a chained DownBlock never merges) and
an UpBlock that takes a pair never merges, so on the decoder's chain only
up0 does. Its backward is the split blocks' kernels. Under data
parallelism no block merges (JAX's ``axis_name is None`` gate): the
kernel's affine would take this rank's moments, not the global batch's.

Data parallelism (``dp``, a ``parallel/dist.py:DataParallel``; JAX's
``axis_name``): in train mode every BatchNorm takes the global batch's
moments, ``all_reduce_mean`` of its stacked [Σy/count, Σy²/count] over the
ranks before the variance, ``count`` local (``layers.py:219-220``), on the
kernel route and on the plain route. The all-reduce sits between a
kernel's stats output and the affine, so autograd hands the kernels' stats
fold (in-kernel, or l outside) the reduced cotangent.

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
    fused_down_block, fused_dual_s2_conv, fused_dual_s2_conv_split, fused_ico_conv_s2s,
    fused_phase_conv_s1, fused_up_block, fused_up_dual_conv, fused_up_dual_conv_pair,
    kernel_geff_enabled, merged_bwd_enabled,
)
from geniconet_tpu_torch.ops.kernels.phase_kernel import pair_join
from geniconet_tpu_torch.ops.phase import phase_merge, phase_split
from geniconet_tpu_torch.ops.upsample import ico_upsample_s2s
from geniconet_tpu_torch.parallel.dist import all_reduce_mean

__all__ = ["IcoConvS2S", "IcoBatchNorm", "DownBlock", "UpBlock", "residual_join",
           "pallas_block_enabled", "merged_bwd_enabled", "kernel_geff_enabled",
           "phase_chain_enabled", "merged_block_enabled"]


def pallas_block_enabled(name: str, pallas_blocks: str | None) -> bool:
    """The JAX package's per-block routing, as a model attribute: with
    ``pallas_blocks`` None every block takes the fused route, otherwise only
    the blocks named in the comma list (e.g. ``"up0,up1,up2"``)."""
    if not pallas_blocks:
        return True
    return name in {s.strip() for s in pallas_blocks.split(",")}


def merged_block_enabled(name: str, merged_block: str | None) -> bool:
    """The JAX package's ``GENICONET_MERGED_BLOCK`` routing as a model
    option: whether block ``name`` runs its training forward as one merged
    kernel (o or p). None, "" or "0" is off, "1" or "all" merges every
    block, and a comma list the blocks it names (e.g. ``"up0,down1"``)."""
    if merged_block in (None, "", "0"):
        return False
    if merged_block in ("1", "all"):
        return True
    return name in {b.strip() for b in merged_block.split(",")}


def phase_chain_enabled(part: str, phase_chain: str | None) -> bool:
    """The JAX package's ``GENICONET_PHASE_CHAIN`` routing as a model
    option: whether ``part`` ("enc" or "dec") runs chained. None or "0" is
    off, "1" chains both halves, "enc" and "dec" one half each."""
    return phase_chain in ("1", part)


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
                merged_bwd: bool = False, kernel_geff: str | None = None):
        """(B, 5, h, w, C_in) -> (B, 5, h, w, C_out), stride 1; act: optional
        float32 (mul, add) prologue relu(x·mul + add); with_stats: also the
        (2, C_out) float32 [Σy, Σy²] of the output; merged_bwd: the backward
        as one merged kernel; kernel_geff: where the stats fold runs."""
        taps, bias = self.params(x.dtype)
        return fused_ico_conv_s2s(x, taps, bias, grid_level(x.shape[2], x.shape[3]),
                                  self.corner_mode, act=act, with_stats=with_stats,
                                  merged_bwd=merged_bwd, kernel_geff=kernel_geff)

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
    ``nn.BatchNorm`` (``use_fast_variance``) to a grid on the plain route.
    ``dp``: the ranks whose moments it averages in train mode (module
    doc), or None."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5, device=None, dp=None):
        super().__init__()
        self.eps, self.dp = eps, dp
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
        if self.dp is not None:  # the global batch's moments (JAX's pmean)
            both = all_reduce_mean(torch.stack([mean, mean2]), self.dp)
            mean, mean2 = both[0], both[1]
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

    def kernel_affine(self, kernel_fn, count):
        """``_StatsBN``'s ``kernel_fn`` mode (the merged blocks, train mode):
        a kernel computes this BatchNorm's affine from its own batch
        moments, so it takes the raw (scale, bias). ``kernel_fn(scale,
        bias)`` returns (aux, stats); the running statistics move from the
        [Σy, Σy²] ``stats`` over ``count`` positions. Returns aux. Raises
        under data parallelism: the kernel's affine would take this rank's
        moments alone (the blocks take the split pair there)."""
        if self.dp is not None:
            raise RuntimeError("IcoBatchNorm.kernel_affine under data parallelism: the "
                               "kernel's affine takes one rank's moments; run the split pair")
        aux, stats = kernel_fn(self.scale, self.bias)
        stats = stats.detach()
        self._moments(stats[0] / count, stats[1] / count, True)
        return aux

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
    return pair_join(a, b, (*aff1, *aff2))


class _Block(nn.Module):
    """The six modules of a residual block (reference BasicIcoS2S*Block)."""

    def __init__(self, in_features, features, corner_mode, fused, merged_bwd, kernel_geff, fold_ok,
                 merged_block, name, device, dp):
        super().__init__()
        kw = dict(corner_mode=corner_mode, device=device)
        self.corner_mode, self.fused, self.merged_bwd = corner_mode, fused, merged_bwd
        # under data parallelism the block runs the split pair (module doc)
        self.merged_block = merged_block_enabled(name, merged_block) and dp is None
        # where the split backward folds the stats cotangent (fused.kernel_geff_enabled)
        self.fold = dict(kernel_geff=kernel_geff, fold_ok=fold_ok)
        self.name = name
        self.conv00 = IcoConvS2S(in_features, features, **kw)
        self.conv10 = IcoConvS2S(in_features, features, **kw)
        self.conv01 = IcoConvS2S(features, features, **kw)
        self.bn00 = IcoBatchNorm(features, device=device, dp=dp)
        self.bn01 = IcoBatchNorm(features, device=device, dp=dp)
        self.bn10 = IcoBatchNorm(features, device=device, dp=dp)

    def _plain_tail(self, x, stride, train):
        """relu(bn01(conv01(relu(bn00(conv00(x))))) + bn10(conv10(x))) on the
        plain route; conv00 and conv10 share x (the JAX route's shared pad)."""
        b0 = torch.relu(self.bn00(self.conv00.plain(x, stride), train))
        b0 = self.bn01(self.conv01.plain(b0), train)
        return torch.relu(b0 + self.bn10(self.conv10.plain(x, stride), train))

    def _merged(self, fn, count):
        """The merged block's forward: ``fn(gamma, beta)`` runs the kernel
        (o or p) with bn00's raw parameters; returns (b0, y10, bn01's and
        bn10's affines)."""
        def run(gamma, beta):
            b0, y10, s00, s01, s10 = fn(gamma, beta)
            return (b0, y10, s01, s10), s00

        b0, y10, s01, s10 = self.bn00.kernel_affine(run, count)
        return b0, y10, self.bn01.affine(s01, count, True), self.bn10.affine(s10, count, True)


class DownBlock(_Block):
    """Residual down block (reference BasicIcoS2SDownBlock), s -> s-1:
    relu(bn01(conv01(relu(bn00(conv00(x))))) + bn10(conv10(x))).
    ``phase_chain``: the fused route in phase form; ``merged_block``: the
    training forward as kernel p; ``dp``: data parallelism (module doc)."""

    def __init__(self, in_features: int, features: int, corner_mode: str = "average",
                 fused: bool = True, merged_bwd: str | None = None, phase_chain: bool = False,
                 kernel_geff: str | None = None, fold_ok: bool = True,
                 merged_block: str | None = None, name: str = "", device=None, dp=None):
        super().__init__(in_features, features, corner_mode, fused, merged_bwd, kernel_geff,
                         fold_ok, merged_block, name, device, dp)
        self.phase_chain = phase_chain

    def forward(self, x, in_act=None, train: bool = False):
        """x: a (B, 5, H, W, C) grid or its 4 parity phases; in_act: the
        pending (mul, add) BN-apply + ReLU of the producing layer. Returns
        the level-(s-1) grid, or its 4 phases on the phase chain."""
        if not self.fused:
            xd = phase_merge(x) if isinstance(x, (tuple, list)) else x
            return self._plain_tail(act_apply(xd, in_act), 2, train)
        phases = x if isinstance(x, (tuple, list)) else phase_split(x)
        phases = tuple(p.contiguous() for p in phases)
        if self.phase_chain and phases[0].shape[2] >= 2:
            return self._chain(phases, in_act, train)
        dt = phases[0].dtype
        if train and self.merged_block:
            def fn(gamma, beta):
                return fused_down_block(
                    phases, *self.conv00.params(dt), *self.conv10.params(dt),
                    *self.conv01.params(dt), gamma, beta,
                    grid_level(phases[0].shape[2], phases[0].shape[3]) + 1, in_act,
                    self.corner_mode, self.fold["fold_ok"], self.bn00.eps, self.merged_bwd,
                    self.fold["kernel_geff"])

            b0, y10, aff01, aff10 = self._merged(fn, float(phases[0].shape[:-1].numel()))
            return residual_join(b0, y10, aff01, aff10)
        r = fused_dual_s2_conv(phases, *self.conv00.params(dt), *self.conv10.params(dt),
                               self.corner_mode, act=in_act, with_stats=train,
                               merged_bwd=merged_bwd_enabled("ds2", self.merged_bwd), **self.fold)
        y00, y10 = r[:2]
        s00, s10 = r[2:] if train else (None, None)
        count = float(y00.shape[:-1].numel())
        r = self.conv01(y00, act=self.bn00.affine(s00, count, train), with_stats=train,
                        merged_bwd=merged_bwd_enabled("std", self.merged_bwd),
                        kernel_geff=self.fold["kernel_geff"])
        b0, s01 = r if train else (r, None)
        return residual_join(b0, y10, self.bn01.affine(s01, count, train),
                             self.bn10.affine(s10, count, train))

    def _chain(self, phases, in_act, train):
        """The phase chain: the stride-2 pair emits level-(s-1) phases, conv01
        runs on them in phase form, the join per phase."""
        dt = phases[0].dtype
        r = fused_dual_s2_conv_split(phases, *self.conv00.params(dt), *self.conv10.params(dt),
                                     self.corner_mode, act=in_act, with_stats=train, **self.fold)
        y00, y10 = r[:2]
        s00, s10 = r[2:] if train else (None, None)
        count = 4.0 * y00[0].shape[:-1].numel()
        r = fused_phase_conv_s1(y00, *self.conv01.params(dt), self.corner_mode,
                                act=self.bn00.affine(s00, count, train), with_stats=train,
                                merged_bwd=merged_bwd_enabled("pcs1", self.merged_bwd),
                                fold_site=self.name, **self.fold)
        b0, s01 = r if train else (r, None)
        aff01 = self.bn01.affine(s01, count, train)
        aff10 = self.bn10.affine(s10, count, train)
        return tuple(residual_join(a, b, aff01, aff10) for a, b in zip(b0, y10))


class UpBlock(_Block):
    """Residual up block (reference BasicIcoS2SUpBlock), s -> s+1. The
    parameter-free upsample is shared by both branches. ``merged_block``:
    the training forward of a grid input as kernel o; ``dp``: data
    parallelism (module doc)."""

    def __init__(self, in_features: int, features: int, corner_mode: str = "average",
                 return_phases: bool = False, fused: bool = True, merged_bwd: str | None = None,
                 kernel_geff: str | None = None, fold_ok: bool = True,
                 merged_block: str | None = None, name: str = "", device=None, dp=None):
        super().__init__(in_features, features, corner_mode, fused, merged_bwd, kernel_geff,
                         fold_ok, merged_block, name, device, dp)
        self.return_phases = return_phases

    def forward(self, x, train: bool = False):
        """(B, 5, h, w, C) level-s grid, or the previous UpBlock's (b0 phases,
        y10 phases, affines) on the decoder's phase chain -> (B, 5, 2h, 2w, F)
        level s+1; on the fused route with ``return_phases``, (b0 phases, y10
        phases, (mul01, add01, mul10, add10)) for the next block or the
        decoder's head instead."""
        pair_in = isinstance(x, tuple)
        if not self.fused:
            if pair_in:  # the previous block's residual tail, then the interleave
                pb0, py10, paff = x
                x = phase_merge(tuple(pair_join(a, b, paff) for a, b in zip(pb0, py10)))
            up = ico_upsample_s2s(x, grid_level(x.shape[2], x.shape[3]), self.corner_mode)
            return self._plain_tail(up, 1, train)
        if train and self.merged_block and not pair_in:
            x = x.contiguous()
            dt = x.dtype

            def fn(gamma, beta):
                return fused_up_block(x, *self.conv00.params(dt), *self.conv10.params(dt),
                                      *self.conv01.params(dt), gamma, beta, self.corner_mode,
                                      self.fold["fold_ok"], self.name, self.bn00.eps,
                                      self.merged_bwd, self.fold["kernel_geff"])

            return self._tail(*self._merged(fn, 4.0 * x.shape[:-1].numel()))
        if pair_in:
            pb0, py10, paff = x
            dt = pb0[0].dtype
            r = fused_up_dual_conv_pair(tuple(p.contiguous() for p in pb0),
                                        tuple(p.contiguous() for p in py10), paff,
                                        *self.conv00.params(dt), *self.conv10.params(dt),
                                        self.corner_mode, with_stats=train, **self.fold)
        else:
            x = x.contiguous()
            dt = x.dtype
            r = fused_up_dual_conv(x, *self.conv00.params(dt), *self.conv10.params(dt),
                                   self.corner_mode, with_stats=train,
                                   merged_bwd=merged_bwd_enabled("upd", self.merged_bwd),
                                   **self.fold)
        y00, y10 = r[:2]
        s00, s10 = r[2:] if train else (None, None)
        count = 4.0 * y00[0].shape[:-1].numel()
        act00 = self.bn00.affine(s00, count, train)
        r = fused_phase_conv_s1(y00, *self.conv01.params(dt), self.corner_mode, act=act00,
                                with_stats=train,
                                merged_bwd=merged_bwd_enabled("pcs1", self.merged_bwd),
                                fold_site=self.name, **self.fold)
        b0, s01 = r if train else (r, None)
        return self._tail(b0, y10, self.bn01.affine(s01, count, train),
                          self.bn10.affine(s10, count, train))

    def _tail(self, b0, y10, aff01, aff10):
        """The raw phases and pending affines with ``return_phases``, else
        the residual join per phase, interleaved."""
        if self.return_phases:
            return b0, y10, (*aff01, *aff10)
        return phase_merge(tuple(residual_join(a, b, aff01, aff10) for a, b in zip(b0, y10)))

"""The icosahedral autoencoder and VAE (reference ico2ico, ico2ico_vae),
eval and train mode.

Port of ``geniconet_tpu/nn/models.py`` (``_Encoder``, ``_Decoder``,
``_Head``, ``IcoAE``, ``IcoVAE``, ``IcoIdentity``, ``reparameterize``):

  IcoAE encoder: conv_in (3 -> w0) ; bn_in ; Down(w0 -> w1) ;
                 Down(w1 -> w2) ; Down(w2 -> w2)
  IcoVAE encoder: conv_in ; bn_in ; Down(w0 -> w1) ; Down(w1 -> w2) (the
                 trunk, level s-2), then the mu / logvar heads: a stride-2
                 conv (w2 -> wz) + BatchNorm each (no ReLU), and
                 z = mu + eps·exp(0.5·logvar)
  decoder: Up(w2 or wz -> w2) ; Up(w2 -> w1) ; Up(w1 -> w0) ; the last
           block's join + 1×1 head (w0 -> 3) + tanh

``pallas_blocks`` is the JAX model attribute: None runs every block on the
fused route (the kernels), a comma list (``conv_in``, ``down0``..``down2``,
``heads``, ``up0``..``up2``, ``head``) only the named blocks, the rest on
the plain route. Every routing trains (``train=True``): the fused head runs
the head+MSE kernel and its backward under ``recon_sse``, and the head
kernel and its backward (``fused_pair_head``) otherwise. ``merged_bwd``
(``ops/kernels/fused.py:merged_bwd_enabled``) puts the fused blocks' conv backward
on the merged one-pass kernels, per kernel family (the VAE's heads are a
``ds2``); ``conv_in`` has no input cotangent and keeps its dtaps kernel.
``kernel_geff`` (``ops/kernels/fused.py:kernel_geff_enabled``) picks the
kernel families whose split backward folds the stats cotangent inside
their kernels; the others fold it before them (kernel l). None, the
default, folds every family inside. ``merged_block``
(``nn/layers.py:merged_block_enabled``: None, "all" or a comma list of
block names) runs the named fused blocks' training forward as one kernel
each (o for an UpBlock, p for a DownBlock), never on a chained DownBlock
or a pair-input UpBlock. ``phase_chain`` is the JAX package's
``GENICONET_PHASE_CHAIN``, in training and in eval: "enc" runs the fused
DownBlocks as the phase chain (kernel m, ``nn/layers.py``), and the
encoder interleaves the phase tuple once, at its end (the VAE's trunk too,
before its heads); "dec" chains the decoder: every fused UpBlock returns
its raw phases and pending affines, and the next one takes them as its
input (kernel n after a fused block, the join and interleave before a
plain one; up0 always takes the latent grid); "1" chains both halves.
``dp`` (a ``parallel/dist.py:DataParallel``, JAX's ``axis_name``) makes
every BatchNorm take the global batch's moments in train mode and keeps
every block off the merged-block route.

Public tensors: grid ``(B, 5·2^s, 2^(s+1), 3)``; latent
``(B, 5·2^(s-3), 2^(s-2), w2)`` (the VAE's: ``wz`` channels). ``decode``
returns float32.
"""

from __future__ import annotations

import torch
from torch import nn

from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.nn.layers import (
    DownBlock, IcoBatchNorm, IcoConvS2S, UpBlock, merged_bwd_enabled, pallas_block_enabled,
    phase_chain_enabled, residual_join,
)
from geniconet_tpu_torch.ops.conv import merge_charts, split_charts
from geniconet_tpu_torch.ops.kernels.fused import (
    fused_dual_s2_conv, fused_pair_head, fused_pair_head_mse, fused_phase_conv_s1,
)
from geniconet_tpu_torch.ops.phase import phase_merge, phase_split

__all__ = ["IcoAE", "IcoVAE", "IcoIdentity", "reparameterize"]


def _check_phase_chain(phase_chain):
    if phase_chain not in (None, "0", "1", "enc", "dec"):
        raise ValueError(f"phase_chain must be None, '0', '1', 'enc' or 'dec', got {phase_chain!r}")


class _Encoder(nn.Module):
    def __init__(self, widths, corner_mode: str, pallas_blocks=None, merged_bwd=None,
                 phase_chain=None, kernel_geff=None, merged_block=None, device=None, dp=None):
        super().__init__()
        w0 = widths[0]
        self.corner_mode = corner_mode
        # the fold placement of the split backward (fused.kernel_geff_enabled)
        self.fold = dict(kernel_geff=kernel_geff, fold_ok=pallas_blocks is None)
        self.fused_in = pallas_block_enabled("conv_in", pallas_blocks)
        self.conv_in = IcoConvS2S(3, w0, corner_mode=corner_mode, device=device)
        self.bn_in = IcoBatchNorm(w0, device=device, dp=dp)
        for k, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"down{k}", DownBlock(
                cin, cout, corner_mode, fused=pallas_block_enabled(f"down{k}", pallas_blocks),
                merged_bwd=merged_bwd, phase_chain=phase_chain_enabled("enc", phase_chain),
                merged_block=merged_block, name=f"down{k}", device=device, dp=dp, **self.fold))
        self.n_down = len(widths) - 1

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, 5, h, w, 3) chart-split grid -> (B, 5, h/2^n, w/2^n, C) after
        the n DownBlocks."""
        if self.fused_in:
            # phase form: the phases feed down0's dual stride-2 conv directly;
            # the input is data, so no input cotangent
            phases = tuple(p.contiguous() for p in phase_split(x))
            r = fused_phase_conv_s1(phases, *self.conv_in.params(x.dtype), self.corner_mode,
                                    with_stats=train, needs_dx=False, **self.fold)
            y, st = r if train else (r, None)
            in_act = self.bn_in.affine(st, 4.0 * y[0].shape[:-1].numel(), train)
        else:
            y = torch.relu(self.bn_in(self.conv_in.plain(x), train))
            in_act = None
        for k in range(self.n_down):
            y = getattr(self, f"down{k}")(y, in_act=in_act if k == 0 else None, train=train)
        # the phase chain hands phases along: one interleave at the end
        return phase_merge(y) if isinstance(y, tuple) else y


class _Head(nn.Module):
    """The 1×1 conv head: kernel (fan_in, F), bias (F,), U(±1/sqrt(fan_in))."""

    def __init__(self, fan_in: int, features: int, device=None):
        super().__init__()
        bound = 1.0 / fan_in**0.5
        self.kernel = nn.Parameter(
            torch.empty(fan_in, features, device=device).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(features, device=device).uniform_(-bound, bound))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The plain route: x·W + b in x's dtype, then a float32 tanh."""
        dt = x.dtype
        return torch.tanh((x @ self.kernel.to(dt) + self.bias.to(dt)).float())


class _Decoder(nn.Module):
    def __init__(self, widths, in_features: int, out_features: int, corner_mode: str,
                 pallas_blocks=None, merged_bwd=None, phase_chain=None, kernel_geff=None,
                 merged_block=None, device=None, dp=None):
        super().__init__()
        cins = (in_features, *widths[:-1])
        # the decoder's phase chain: every fused block hands its raw phases and
        # pending affines on, the last one to the head (JAX models.py:283-291)
        chain = phase_chain_enabled("dec", phase_chain)
        for k, (cin, cout) in enumerate(zip(cins, widths)):
            self.add_module(f"up{k}", UpBlock(
                cin, cout, corner_mode, return_phases=chain or k == len(widths) - 1,
                fused=pallas_block_enabled(f"up{k}", pallas_blocks), merged_bwd=merged_bwd,
                kernel_geff=kernel_geff, fold_ok=pallas_blocks is None,
                merged_block=merged_block, name=f"up{k}", device=device, dp=dp))
        self.n_up = len(widths)
        self.fused_head = pallas_block_enabled("head", pallas_blocks)
        self.head = _Head(widths[-1], out_features, device=device)

    def forward(self, z: torch.Tensor, train: bool = False, target=None) -> torch.Tensor:
        """(B, 5, hz, wz, C) -> (B, 5, 8hz, 8wz, out_features) float32; with
        target = (tpack, tpoles), the per-sample position SSE instead."""
        x = z
        for k in range(self.n_up):
            x = getattr(self, f"up{k}")(x, train=train)
        if isinstance(x, tuple):  # fused last block: (b0 phases, y10 phases, affines)
            b0, y10, (mul01, add01, mul10, add10) = x
            if self.fused_head:
                dt = b0[0].dtype
                head = (self.head.kernel.to(dt), self.head.bias.to(dt))
                affines = (mul01, add01, mul10, add10)
                if target is not None:
                    return fused_pair_head_mse(b0, y10, affines, *head, *target)
                return phase_merge(fused_pair_head(b0, y10, affines, *head))
            x = phase_merge(tuple(residual_join(a, b, (mul01, add01), (mul10, add10))
                                  for a, b in zip(b0, y10)))
        out = self.head(x)
        if target is None:
            return out
        return _position_sse(out, *target)


def _position_sse(out, tpack, tpoles):
    """Per-sample Σ (v − t)² over the grid, phase by phase against the packed
    target (``ops/vertices.pack_target_phases``), plus the two poles (the
    means over charts of the corner cells) — the JAX decoder's XLA form of
    the fused head+MSE."""
    F = out.shape[-1]
    sse = 0.0
    for p in range(4):
        d = out[:, :, p >> 1 :: 2, p & 1 :: 2, :] - tpack[..., p * F : (p + 1) * F].float()
        sse = sse + (d * d).sum(dim=(1, 2, 3, 4))
    dn = out[:, :, 0, 0, :].mean(dim=1) - tpoles[:, 0:F].float()
    ds = out[:, :, -1, -1, :].mean(dim=1) - tpoles[:, F : 2 * F].float()
    return sse + (dn * dn).sum(dim=1) + (ds * ds).sum(dim=1)


class IcoAE(nn.Module):
    """Deterministic icosahedral autoencoder (reference ico2ico).

    ``dtype`` is the activation (compute) dtype, float32 or bfloat16;
    parameters stay float32. Sums run in float32 inside every conv.
    ``train`` selects batch statistics (and updates the running ones) in
    every BatchNorm, as flax's ``apply(train=True, mutable=["batch_stats"])``.
    ``merged_bwd``: the kernel families whose backward is merged;
    ``kernel_geff``: those whose split backward folds in-kernel;
    ``phase_chain``: None, "0", "enc", "dec" or "1"; ``merged_block``: the
    blocks whose training forward is one kernel; ``dp``: data parallelism
    (module doc)."""

    def __init__(self, subdivisions: int = 5, widths=(64, 128, 256),
                 corner_mode: str = "average", dtype: torch.dtype = torch.float32,
                 pallas_blocks: str | None = None, merged_bwd: str | None = None,
                 phase_chain: str | None = None, kernel_geff: str | None = None,
                 merged_block: str | None = None, device=None, dp=None):
        super().__init__()
        if subdivisions < 3:
            raise ValueError("IcoAE needs subdivisions >= 3 (three stride-2 stages)")
        _check_phase_chain(phase_chain)
        w0, w1, w2 = widths
        self.subdivisions, self.dtype, self.pallas_blocks = subdivisions, dtype, pallas_blocks
        self.merged_bwd, self.phase_chain, self.kernel_geff = merged_bwd, phase_chain, kernel_geff
        self.merged_block = merged_block
        self.encoder = _Encoder((w0, w1, w2, w2), corner_mode, pallas_blocks, merged_bwd,
                                phase_chain, kernel_geff, merged_block, device=device, dp=dp)
        self.decoder = _Decoder((w2, w1, w0), w2, 3, corner_mode, pallas_blocks, merged_bwd,
                                phase_chain, kernel_geff, merged_block, device=device, dp=dp)

    def encode(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """grid (B, 5·2^s, 2^(s+1), 3) -> latent (B, 5·2^(s-3), 2^(s-2), w2), in ``dtype``."""
        return merge_charts(self.encoder(split_charts(x.to(self.dtype), self.subdivisions),
                                         train))

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """latent -> grid (B, 5·2^s, 2^(s+1), 3), float32."""
        zc = split_charts(z.to(self.dtype), self.subdivisions - 3)
        return merge_charts(self.decoder(zc, train))

    def recon_sse(self, x, tpack, tpoles, train: bool = False) -> torch.Tensor:
        """Per-sample position squared-error sum of the reconstruction against
        a packed target (``ops/vertices.pack_target_phases``): equals
        sum((grid_to_vertices(self(x)) - target_pos)**2) per sample."""
        z = self.encoder(split_charts(x.to(self.dtype), self.subdivisions), train)
        return self.decoder(z, train, target=(tpack, tpoles))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, train), train)


class IcoIdentity(nn.Module):
    """Debug model (the JAX ``IcoIdentity``; reference ``Identity``,
    models.py:64-73): the output is the input, plus a parameter ``W`` that
    contributes zero and gets a zero gradient, so a training loop's gradient
    machinery can run on a known identity. ``W`` has the grid's shape (1,
    5·2^s, 2^(s+1), 3), N(0, 1) at construction; the JAX module shapes it
    from its first input, the same grid."""

    def __init__(self, subdivisions: int = 5, device=None):
        super().__init__()
        self.subdivisions = subdivisions
        self.W = nn.Parameter(torch.randn(1, *ico.grid_shape(subdivisions), 3, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x + (self.W - self.W)  # zero contribution, zero gradient


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, generator=None) -> torch.Tensor:
    """z = mu + eps·exp(0.5·logvar) with eps ~ N(0, 1) drawn from
    ``generator`` (a ``torch.Generator`` on mu's device) in float32, cast
    to mu's dtype (reference models.py:89-92). The JAX package draws eps
    from its own PRNG, so the two never share samples."""
    std = torch.exp(0.5 * logvar)
    eps = torch.randn(std.shape, generator=generator, device=std.device).to(std.dtype)
    return eps * std + mu


def _bn_apply(y: torch.Tensor, aff) -> torch.Tensor:
    """A BatchNorm's (mul, add) applied in float32, without ReLU, cast back."""
    mul, add = aff
    return (y.float() * mul + add).to(y.dtype)


class IcoVAE(nn.Module):
    """Icosahedral VAE (reference ico2ico_vae).

    ``dtype``, ``pallas_blocks``, ``merged_bwd``, ``phase_chain``,
    ``kernel_geff``, ``merged_block``, ``dp`` and ``train`` as ``IcoAE``; the mu / logvar heads are
    the block ``"heads"``: on the fused route both stride-2 convs run as one
    dual stride-2 phase conv (no act prologue, BatchNorm sums when training;
    family ``ds2`` of ``merged_bwd`` and ``kernel_geff``; never chained),
    then each BatchNorm's affine without ReLU."""

    def __init__(self, subdivisions: int = 5, widths=(64, 128, 256), latent_features: int = 512,
                 corner_mode: str = "average", dtype: torch.dtype = torch.float32,
                 pallas_blocks: str | None = None, merged_bwd: str | None = None,
                 phase_chain: str | None = None, kernel_geff: str | None = None,
                 merged_block: str | None = None, device=None, dp=None):
        super().__init__()
        if subdivisions < 3:
            raise ValueError("IcoVAE needs subdivisions >= 3 (three stride-2 stages)")
        _check_phase_chain(phase_chain)
        w0, w1, w2 = widths
        self.subdivisions, self.dtype, self.pallas_blocks = subdivisions, dtype, pallas_blocks
        self.merged_bwd, self.phase_chain, self.kernel_geff = merged_bwd, phase_chain, kernel_geff
        self.merged_block = merged_block
        self.corner_mode = corner_mode
        self.fused_heads = pallas_block_enabled("heads", pallas_blocks)
        self.encoder = _Encoder((w0, w1, w2), corner_mode, pallas_blocks, merged_bwd,
                                phase_chain, kernel_geff, merged_block, device=device, dp=dp)
        self.mu_conv = IcoConvS2S(w2, latent_features, corner_mode, device=device)
        self.mu_bn = IcoBatchNorm(latent_features, device=device, dp=dp)
        self.logvar_conv = IcoConvS2S(w2, latent_features, corner_mode, device=device)
        self.logvar_bn = IcoBatchNorm(latent_features, device=device, dp=dp)
        self.decoder = _Decoder((w2, w1, w0), latent_features, 3, corner_mode, pallas_blocks,
                                merged_bwd, phase_chain, kernel_geff, merged_block,
                                device=device, dp=dp)

    def encode_trunk(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """grid -> the trunk's chart-split features (B, 5, 2^(s-2), 2^(s-1), w2)."""
        return self.encoder(split_charts(x.to(self.dtype), self.subdivisions), train)

    def encode_heads(self, feat: torch.Tensor, train: bool = False):
        """Trunk features -> (mu, logvar), each (B, 5·2^(s-3), 2^(s-2), wz)
        in ``dtype``."""
        if self.fused_heads:
            phases = tuple(p.contiguous() for p in phase_split(feat))
            dt = phases[0].dtype
            r = fused_dual_s2_conv(phases, *self.mu_conv.params(dt),
                                   *self.logvar_conv.params(dt), self.corner_mode,
                                   with_stats=train,
                                   merged_bwd=merged_bwd_enabled("ds2", self.merged_bwd),
                                   fold_ok=self.pallas_blocks is None,
                                   kernel_geff=self.kernel_geff)
            y_mu, y_lv = r[:2]
            s_mu, s_lv = r[2:] if train else (None, None)
            count = float(y_mu.shape[:-1].numel())
            mu = _bn_apply(y_mu, self.mu_bn.affine(s_mu, count, train))
            logvar = _bn_apply(y_lv, self.logvar_bn.affine(s_lv, count, train))
        else:
            mu = self.mu_bn(self.mu_conv.plain(feat, 2), train)
            logvar = self.logvar_bn(self.logvar_conv.plain(feat, 2), train)
        return merge_charts(mu), merge_charts(logvar)

    def encode(self, x: torch.Tensor, train: bool = False):
        """grid -> (mu, logvar)."""
        return self.encode_heads(self.encode_trunk(x, train), train)

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """latent -> grid (B, 5·2^s, 2^(s+1), 3), float32."""
        zc = split_charts(z.to(self.dtype), self.subdivisions - 3)
        return merge_charts(self.decoder(zc, train))

    def forward(self, x: torch.Tensor, train: bool = False, sample: bool = True,
                generator=None):
        """-> (reconstruction, mu, logvar); the decoder reads
        ``reparameterize(mu, logvar, generator)`` if ``sample``, else mu."""
        mu, logvar = self.encode(x, train)
        z = reparameterize(mu, logvar, generator) if sample else mu
        return self.decode(z, train), mu, logvar

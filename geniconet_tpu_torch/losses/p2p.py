"""Point-to-point and KLD losses.

Port of ``geniconet_tpu/losses/p2p.py`` (reference losses.py):

* ``p2p_loss`` (losses.py:47-82): the pole vertices rebuilt from the grid as
  ``grid_to_vertices`` does, then ``f_pos·MSE(v, target_pos) +
  f_nor·mean(1 − cos(normals, target_nor)) + f_lap·MSE(lap, target_lap)``,
  the normals and Laplacian computed on the predicted vertices each step and
  the targets read from the dataset's ``(V, 9)`` rows (pos | normal |
  laplacian). A term whose factor is 0 is skipped. The normals and the
  Laplacian take the grid-stencil forms of ``ops/mesh_math.py`` unless
  ``allow_grid=False`` asks for the vertex-table forms; the values agree.
* ``kld_loss`` (losses.py:105): ``mean_B(−0.5·mean_dims(1 + logvar − mu²
  − exp(logvar)))``, a mean over the latent dims, not a sum.
* ``p2pkld_loss`` = P2P + f_kl·kl_factor·KLD, with ``kl_factor_at_epoch``
  the reference's step decay of the KL factor.

Loss factors per model (reference run.py:689-696): AE pos/nor/lap = 1/0/0,
VAE 0.6/0.2/0.2 with kl 1. Reductions are per-sample means, then a
weighted batch mean.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.mesh_math import (
    laplacian, laplacian_grid, safe_norm, vertex_normals, vertex_normals_grid,
)
from geniconet_tpu_torch.ops.vertices import grid_to_vertices

__all__ = ["LossFactors", "loss_factors", "p2p_loss", "kld_loss", "kl_factor_at_epoch",
           "p2pkld_loss"]


@dataclass(frozen=True)
class LossFactors:
    pos: float = 1.0
    nor: float = 0.0
    lap: float = 0.0
    kl: float = 0.0  # multiplied by the epoch schedule at call time

    @staticmethod
    def ae() -> "LossFactors":
        return LossFactors(1.0, 0.0, 0.0, 0.0)

    @staticmethod
    def vae() -> "LossFactors":
        return LossFactors(0.6, 0.2, 0.2, 1.0)


def loss_factors(cfg) -> LossFactors:
    """``Config.loss_factors`` (reference run.py:689-696): the model's
    defaults with the config's per-term overrides."""
    base = LossFactors.vae() if cfg.model.is_vae else LossFactors.ae()
    over = dict(pos=cfg.f_pos, nor=cfg.f_nor, lap=cfg.f_lap, kl=cfg.f_kl)
    return LossFactors(**{k: getattr(base, k) if v is None else v for k, v in over.items()})


def _wmean(per_sample: torch.Tensor, weights=None, denom=None) -> torch.Tensor:
    """Weighted mean over the batch axis (weights None: plain mean); ``denom``
    overrides the normaliser, else it is max(Σw, 1)."""
    if denom is not None:
        w = 1.0 if weights is None else weights.float()
        return (per_sample * w).sum() / denom
    if weights is None:
        return per_sample.mean()
    w = weights.float()
    return (per_sample * w).sum() / torch.clamp_min(w.sum(), 1.0)


def _cosine(a, b):
    """Cosine along the last axis with eps-floored norms (torch
    CosineSimilarity), finite gradients at degenerate normals."""
    return (a * b).sum(dim=-1) / (safe_norm(a, keepdim=False) * safe_norm(b, keepdim=False))


def p2p_loss(output_grid, target, subdivisions: int, factors: LossFactors, weights=None,
             wsum=None, allow_grid: bool = True):
    """P2P loss of a (B, 5·2^s, 2^(s+1), 3) grid prediction against a
    (B, V, 9) target; weights: optional (B,) sample weights. Returns (loss,
    {"mse", "cos", "lap"})."""
    v = grid_to_vertices(output_grid.float(), subdivisions)  # (B, V, 3)
    t = target.float()
    l_pos = _wmean(((v - t[..., 0:3]) ** 2).mean(dim=(1, 2)), weights, wsum)
    loss = factors.pos * l_pos
    zero = torch.zeros((), device=l_pos.device)
    metrics = {"mse": l_pos, "cos": zero, "lap": zero}
    if factors.nor == 0.0 and factors.lap == 0.0:
        return loss, metrics

    V = ico.num_vertices(subdivisions)
    if allow_grid:
        h, w = ico.chart_shape(subdivisions)
        B = output_grid.shape[0]
        xc = output_grid.float().reshape(B, 5, h, w, 3)

        def grid_and_poles(rows):
            return rows[:, : V - 2].reshape(B, 5, h, w, 3), rows[:, V - 2 :]

    if factors.nor != 0.0:
        t_nor = t[..., 3:6]
        if allow_grid:
            ng, npl = vertex_normals_grid(xc, subdivisions)
            tg, tp = grid_and_poles(t_nor)
            per_sample = ((1.0 - _cosine(ng, tg)).sum(dim=(1, 2, 3))
                          + (1.0 - _cosine(npl, tp)).sum(dim=1)) / V
        else:
            per_sample = (1.0 - _cosine(vertex_normals(v, subdivisions), t_nor)).mean(dim=1)
        metrics["cos"] = _wmean(per_sample, weights, wsum)
        loss = loss + factors.nor * metrics["cos"]

    if factors.lap != 0.0:
        t_lap = t[..., 6:9]
        if allow_grid:
            lg, lpl = laplacian_grid(xc, subdivisions)
            tg, tp = grid_and_poles(t_lap)
            per_sample = (((lg - tg) ** 2).sum(dim=(1, 2, 3, 4))
                          + ((lpl - tp) ** 2).sum(dim=(1, 2))) / (V * 3.0)
        else:
            per_sample = ((laplacian(v, subdivisions) - t_lap) ** 2).mean(dim=(1, 2))
        metrics["lap"] = _wmean(per_sample, weights, wsum)
        loss = loss + factors.lap * metrics["lap"]
    return loss, metrics


def kld_loss(mu, logvar, weights=None, wsum=None) -> torch.Tensor:
    """mean_B(−0.5·mean_dims(1 + logvar − mu² − exp(logvar))) (losses.py:105)."""
    mu = mu.float().reshape(mu.shape[0], -1)
    logvar = logvar.float().reshape(logvar.shape[0], -1)
    per_sample = -0.5 * (1.0 + logvar - mu**2 - torch.exp(logvar)).mean(dim=1)
    return _wmean(per_sample, weights, wsum)


def kl_factor_at_epoch(epoch, initial: float = 1.0, step_size: int = 25,
                       gamma: float = 0.9) -> float:
    """The KL factor during epoch ``epoch``: ``initial·gamma^⌊epoch /
    step_size⌋`` (the reference decays it by gamma at the end of every
    step_size-th epoch, run.py:491-493, losses.py:116-118)."""
    return initial * gamma ** math.floor(epoch / step_size)


def p2pkld_loss(output_grid, mu, logvar, target, subdivisions: int, factors: LossFactors,
                kl_factor, weights=None, wsum=None, allow_grid: bool = True):
    """P2P + f_kl·kl_factor·KLD (reference losses.py:137-142); the metrics
    add "recon" (the P2P loss) and "kld"."""
    recon, metrics = p2p_loss(output_grid, target, subdivisions, factors, weights, wsum,
                              allow_grid=allow_grid)
    kld = kld_loss(mu, logvar, weights, wsum)
    return recon + factors.kl * kl_factor * kld, {**metrics, "recon": recon, "kld": kld}

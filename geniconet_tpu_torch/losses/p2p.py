"""The AE's point-to-point position loss.

Port of the position part of ``geniconet_tpu/losses/p2p.py`` (reference
losses.py:47-82): ``LossFactors`` with the per-model defaults, the weighted
batch mean ``_wmean``, and ``p2p_loss``'s position term. The normal and
Laplacian terms (the VAE's) are not ported yet: a factor other than 0 for
them raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from geniconet_tpu_torch.ops.vertices import grid_to_vertices

__all__ = ["LossFactors", "loss_factors", "p2p_loss"]


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


def p2p_loss(output_grid, target, subdivisions: int, factors: LossFactors, weights=None,
             wsum=None):
    """Position loss of a (B, 5·2^s, 2^(s+1), 3) grid prediction against a
    (B, V, >=3) target: factors.pos · weighted mean of the per-sample
    mean((v − t)²). Returns (loss, {"mse", "cos", "lap"})."""
    if factors.nor != 0.0 or factors.lap != 0.0:
        raise NotImplementedError("p2p_loss: the normal and Laplacian terms are not ported yet")
    v = grid_to_vertices(output_grid.float(), subdivisions)
    l_pos = _wmean(((v - target[..., 0:3].float()) ** 2).mean(dim=(1, 2)), weights, wsum)
    zero = torch.zeros((), device=l_pos.device)
    return factors.pos * l_pos, {"mse": l_pos, "cos": zero, "lap": zero}

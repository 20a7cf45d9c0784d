"""The AE and VAE training step on one device.

Port of the single-device path of ``geniconet_tpu/train/trainer.py``:
``Trainer._loss`` (trainer.py:363-418) and ``Trainer._train_step``
(trainer.py:467-498): loss and gradients, Adam (``optax.adam`` with the
cyclic LR evaluated at the number of updates made so far, so the first
update uses ``lr_base``), the BatchNorm running statistics the forward
updated, and the metrics total / mse / cos / lap (the VAE's also recon /
kld) / lr / finite / grad_norm. The loss takes one of three branches:

* the VAE (``ico2ico_vae``): ``IcoVAE`` in train mode with eps drawn from
  the trainer's ``torch.Generator`` (seeded ``seed + 2`` by ``init_state``,
  as the JAX state's PRNG key; the two never share samples), then
  ``p2pkld_loss`` with the epoch's KL factor; ``last_misc`` keeps the
  batch's (mu, logvar);
* the AE with position-only factors: the decoder returns the per-sample
  position SSE against the packed target (the fused head+MSE kernel), so
  the reconstruction never reaches device memory;
* the AE with normal or Laplacian factors: the model's reconstruction,
  then ``p2p_loss``.

The models are the JAX defaults, ``pallas_blocks=None``: every block on the
kernels, forward with BatchNorm sums and hand-written backward; with
``merged_bwd`` (the JAX package's ``GENICONET_MERGED_BWD``, here a
constructor argument) the backward of the named kernel families runs on
the merged one-pass kernels; ``kernel_geff`` (``GENICONET_KERNEL_GEFF``)
picks the families whose split backward folds the stats cotangent inside
its kernels, the rest folding it before them (kernel l); ``phase_chain``
(``GENICONET_PHASE_CHAIN``) runs the encoder ("enc": kernel m), the
decoder ("dec": kernel n) or both ("1") as the phase chain. The JAX
package's TPU workarounds for the VAE at batch 24 and more (its split step
and ``pallas_blocks`` default) are not ported. Epochs, validation and
checkpoints are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from geniconet_tpu_torch import device as devices
from geniconet_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.losses.p2p import (
    _wmean, kl_factor_at_epoch, loss_factors, p2p_loss, p2pkld_loss,
)
from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
from geniconet_tpu_torch.ops.vertices import pack_target_phases
from geniconet_tpu_torch.train.schedule import cyclic_triangular

__all__ = ["TrainState", "Trainer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    optimizer: torch.optim.Adam
    step: int = 0  # updates made so far; drives the cyclic LR


class Trainer:
    """Owns the model and runs the train step, on the card unless
    ``device="cpu"``. ``merged_bwd``: None, "all" or a comma list of
    kernel families (``nn/layers.py:merged_bwd_enabled``); ``phase_chain``:
    None, "0", "enc", "dec" or "1"; ``kernel_geff``: None (every family
    folds in-kernel) or a ``GENICONET_KERNEL_GEFF`` value
    (``nn/layers.py:kernel_geff_enabled``)."""

    def __init__(self, cfg, device="cuda", merged_bwd: str | None = None,
                 phase_chain: str | None = None, kernel_geff: str | None = None):
        m = cfg.model
        self.cfg, self.device, self.s = cfg, devices.resolve(device), m.subdivisions
        self.is_vae = m.is_vae
        self.factors = loss_factors(cfg)
        self.fused_mse = not self.is_vae and self.factors.nor == 0.0 and self.factors.lap == 0.0
        dtype = _DTYPES[m.compute_dtype]
        routing = dict(merged_bwd=merged_bwd, phase_chain=phase_chain, kernel_geff=kernel_geff,
                       device=self.device)
        if self.is_vae:
            self.model = IcoVAE(m.subdivisions, tuple(m.widths), m.latent_features,
                                m.corner_mode, dtype, **routing)
        else:
            self.model = IcoAE(m.subdivisions, tuple(m.widths), m.corner_mode, dtype, **routing)
        o = cfg.optim
        self.lr_fn = partial(cyclic_triangular, base_lr=o.lr_base, max_lr=o.lr_max,
                             step_size_up=o.step_size_up, step_size_down=o.step_size_down)
        self.generator = None  # the VAE's eps, from init_state
        self.last_misc = None  # the VAE's last (mu, logvar), reference run.py:274-277

    def init_state(self, variables, seed: int = 0) -> TrainState:
        """Load a flax-layout variable tree (``bridge``), seed the VAE's
        sampling generator and start Adam."""
        sd = flax_to_state_dict(variables)
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 2)
        o = self.cfg.optim
        return TrainState(torch.optim.Adam(self.model.parameters(), lr=self.lr_fn(0),
                                           betas=(o.b1, o.b2), eps=o.eps))

    def variables(self) -> dict:
        """The model's parameters and BatchNorm statistics as a flax tree."""
        return state_dict_to_flax(self.model.state_dict())

    def loss(self, x, y, wt, train: bool = True, epoch: int = 0):
        """(loss, metrics) of one batch: x (B, H, W, 3) grids, y (B, V, 9)
        targets, wt (B,) sample weights; ``epoch`` sets the VAE's KL factor."""
        if self.is_vae:
            recon, mu, logvar = self.model(x, train=train, sample=True, generator=self.generator)
            t = self.cfg.train
            kf = kl_factor_at_epoch(epoch, step_size=t.factor_step_size, gamma=t.factor_gamma)
            self.last_misc = (mu.detach(), logvar.detach())
            return p2pkld_loss(recon, mu, logvar, y, self.s, self.factors, kf, wt)
        if not self.fused_mse:
            return p2p_loss(self.model(x, train=train), y, self.s, self.factors, wt)
        tpack, tpoles = pack_target_phases(y, self.s)
        sse = self.model.recon_sse(x, tpack, tpoles, train=train)
        l_pos = _wmean(sse / (ico.num_vertices(self.s) * 3.0), wt)
        zero = torch.zeros((), device=l_pos.device)
        return self.factors.pos * l_pos, {"mse": l_pos.detach(), "cos": zero, "lap": zero}

    def train_step(self, state: TrainState, x, y, wt, epoch: int = 0) -> dict:
        """One update; returns the metrics as 0-d tensors (lr a float)."""
        lr = self.lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(x, y, wt, train=True, epoch=epoch)
        loss.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                          for g in grads]))
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(total=loss.detach(), lr=lr, finite=torch.isfinite(loss.detach()),
                       grad_norm=grad_norm)
        return metrics

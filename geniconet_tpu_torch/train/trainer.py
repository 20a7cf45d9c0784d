"""The AE training step on one device.

Port of the single-device AE path of ``geniconet_tpu/train/trainer.py``:
the fused-MSE branch of ``Trainer._loss`` (the decoder returns the
per-sample position SSE against the packed target; trainer.py:384-410) and
``Trainer._train_step`` (trainer.py:467-498): loss and gradients, Adam
(``optax.adam`` with the cyclic LR evaluated at the number of updates made
so far, so the first update uses ``lr_base``), the BatchNorm running
statistics the forward updated, and the metrics total / mse / lr / finite /
grad_norm.

The model is the JAX AE default, ``pallas_blocks=None`` (trainer.py:145-161):
every block on the kernels, forward with BatchNorm sums and hand-written
backward, and the loss from the fused head+MSE kernel, so the
reconstruction never reaches device memory. The VAE, the other loss
terms, epochs, validation and checkpoints are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from geniconet_tpu_torch import device as devices
from geniconet_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.losses.p2p import _wmean, loss_factors
from geniconet_tpu_torch.nn.models import IcoAE
from geniconet_tpu_torch.ops.vertices import pack_target_phases
from geniconet_tpu_torch.train.schedule import cyclic_triangular

__all__ = ["TrainState", "Trainer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    optimizer: torch.optim.Adam
    step: int = 0  # updates made so far; drives the cyclic LR


class Trainer:
    """Owns the model and runs the AE train step, on the card unless
    ``device="cpu"``."""

    def __init__(self, cfg, device="cuda"):
        m = cfg.model
        if m.is_vae:
            raise NotImplementedError("the VAE trainer is not ported yet (ROADMAP Queue 1)")
        self.factors = loss_factors(cfg)
        if self.factors.nor != 0.0 or self.factors.lap != 0.0:
            raise NotImplementedError("only the position loss (the AE's) is ported")
        self.cfg, self.device, self.s = cfg, devices.resolve(device), m.subdivisions
        self.model = IcoAE(m.subdivisions, tuple(m.widths), m.corner_mode,
                           _DTYPES[m.compute_dtype], device=self.device)
        o = cfg.optim
        self.lr_fn = partial(cyclic_triangular, base_lr=o.lr_base, max_lr=o.lr_max,
                             step_size_up=o.step_size_up, step_size_down=o.step_size_down)

    def init_state(self, variables) -> TrainState:
        """Load a flax-layout variable tree (``bridge``) and start Adam."""
        sd = flax_to_state_dict(variables)
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        o = self.cfg.optim
        return TrainState(torch.optim.Adam(self.model.parameters(), lr=self.lr_fn(0),
                                           betas=(o.b1, o.b2), eps=o.eps))

    def variables(self) -> dict:
        """The model's parameters and BatchNorm statistics as a flax tree."""
        return state_dict_to_flax(self.model.state_dict())

    def loss(self, x, y, wt, train: bool = True):
        """(loss, metrics) of one batch: x (B, H, W, 3) grids, y (B, V, >=3)
        targets, wt (B,) sample weights."""
        tpack, tpoles = pack_target_phases(y, self.s)
        sse = self.model.recon_sse(x, tpack, tpoles, train=train)
        l_pos = _wmean(sse / (ico.num_vertices(self.s) * 3.0), wt)
        zero = torch.zeros((), device=l_pos.device)
        return self.factors.pos * l_pos, {"mse": l_pos.detach(), "cos": zero, "lap": zero}

    def train_step(self, state: TrainState, x, y, wt) -> dict:
        """One update; returns the metrics as 0-d tensors (lr a float)."""
        lr = self.lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(x, y, wt, train=True)
        loss.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                          for g in grads]))
        state.optimizer.step()
        state.step += 1
        metrics.update(total=loss.detach(), lr=lr, finite=torch.isfinite(loss.detach()),
                       grad_norm=grad_norm)
        return metrics

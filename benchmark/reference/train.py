"""The published training step in plain float32 PyTorch: the model's loss,
its gradients by autograd, and Adam under the cyclic triangular learning
rate (torch ``CyclicLR`` stepped every batch, evaluated at the number of
updates made so far).

``follow`` runs the first steps of a training run from given parameters
on given batches and returns what the benchmark compares: each step's
loss, the first step's gradient and the parameters after the last step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import loss as L
from benchmark.reference import model as M

STATS = ("bn_mean", "bn_var")  # BatchNorm running statistics: not trained


def cyclic_lr(step: int, base_lr: float, max_lr: float, up: int, down: int) -> float:
    """Rises from base_lr to max_lr over ``up`` steps and falls back over
    ``down``, repeating; step 0 gives base_lr. Float32 arithmetic."""
    f32 = np.float32
    pos = f32(step) % f32(up + down)
    frac = pos / f32(up) if pos <= up else f32(1.0) - (pos - f32(up)) / f32(down)
    return float(f32(base_lr) + f32(max_lr - base_lr) * frac)


def trainable(cfg: dict) -> list[str]:
    model = cfg["model"]
    return [name for name, _, kind, _ in M.param_specs(model["name"], model["widths"],
                                                       model["latent_features"])
            if kind not in STATS]


def step_loss(cfg: dict, p: dict, x: torch.Tensor, y: torch.Tensor, s: int, eps=None,
              kl_factor: float = 1.0, q=M.identity) -> torch.Tensor:
    """The training loss of one batch: grids x (B, H, W, 3), targets y
    (B, V, 9); the VAE's eps in the public latent layout."""
    f = cfg["loss"]
    if cfg["model"]["name"].endswith("_vae"):
        recon, mu, logvar = M.vae(p, x, s, True, eps, q)
        v = L.grid_to_vertices(recon, s)
        return L.p2p(v, y, s, f) + f["kl"] * kl_factor * L.kld(mu, logvar)
    return L.p2p(L.grid_to_vertices(M.autoencoder(p, x, s, True, q), s), y, s, f)


def follow(cfg: dict, params0: dict, batches, s: int, eps=None, q=M.identity) -> dict:
    """Train from ``params0`` (name -> float32 tensor) over ``batches``
    ((x, y) pairs), one Adam update each; ``eps``: the VAE's noise of each
    step. Returns {"losses": [float], "grad1": {name: the first step's
    gradient}, "moments1": {BatchNorm name: (mean, var) of the first
    step's batch}, "params": {name: the trained parameters after the last
    step}}."""
    o = cfg["optim"]
    b1, b2 = o["b1"], o["b2"]
    names = trainable(cfg)
    p = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v2 = {k: torch.zeros_like(p[k]) for k in names}
    out = {"losses": [], "grad1": None}
    with M.exact_float32():
        for t, (x, y) in enumerate(batches):
            for k in names:
                p[k].requires_grad_(True)
            pt = M.Recording(p) if t == 0 else p
            loss = step_loss(cfg, pt, x, y, s, None if eps is None else eps[t], q=q)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            out["losses"].append(float(loss.detach()))
            if t == 0:
                out["grad1"] = {k: g.detach().clone() for k, g in zip(names, grads)}
                out["moments1"] = pt.moments
            lr = cyclic_lr(t, o["lr_base"], o["lr_max"], o["step_size_up"], o["step_size_down"])
            with torch.no_grad():
                for k, g in zip(names, grads):
                    p[k].requires_grad_(False)
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = v2[k].sqrt() / math.sqrt(1 - b2 ** (t + 1)) + o["eps"]
                    p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** (t + 1)))
    out["params"] = {k: p[k].detach() for k in names}
    return out

"""Seeded weights, made on the device in a few large calls.

The published init: conv taps and bias U(±1/sqrt(7·C_in)), the head's
kernel and bias U(±1/sqrt(fan_in)), BatchNorm scale 1, bias 0, running mean
0 and var 1. ``random_stats`` draws the BatchNorm affines instead (scale
U(0.5, 1.5), bias 0.1·N(0, 1)), so that eval-mode BatchNorm is not the
identity; ``running_stats`` then sets the running statistics to a batch's
moments, as training leaves them, so that a reconstruction depends on its
input as a trained model's does (with drawn statistics the activations
shrink layer by layer and every mesh reconstructs to nearly the same
output).
"""

from __future__ import annotations

import torch

from benchmark.reference import model as M
from benchmark.reference.model import exact_float32


def make(cfg: dict, seed: int, device, random_stats: bool = False) -> dict:
    """{name: float32 tensor on ``device``} for every entry of
    ``reference.model.param_specs``."""
    m = cfg["model"]
    specs = M.param_specs(m["name"], m["widths"], m["latent_features"])
    sizes = [torch.Size(shape).numel() for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    normal = torch.randn(sum(sizes), generator=gen, device=device) if random_stats else None
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(specs, sizes):
        u = uniform[at : at + n].reshape(shape)
        if kind in ("conv_taps", "conv_bias", "head_kernel", "head_bias"):
            t = (2.0 * u - 1.0) / fan_in**0.5
        elif random_stats and kind == "bn_scale":
            t = 0.5 + u
        elif random_stats and kind == "bn_bias":
            t = 0.1 * normal[at : at + n].reshape(shape)
        else:
            t = torch.full(shape, 1.0 if kind in ("bn_scale", "bn_var") else 0.0, device=device)
        out[name] = t.contiguous()
        at += n
    return out


def running_stats(cfg: dict, params: dict, x: torch.Tensor, s: int) -> dict:
    """``params`` with every BatchNorm's running mean and var set to the
    moments of the grids x in a train-mode pass of the float32 reference."""
    rec = M.Recording(params)
    with torch.no_grad(), exact_float32():
        if cfg["model"]["name"].endswith("_vae"):
            M.vae(rec, x, s, True)
        else:
            M.autoencoder(rec, x, s, True)
    out = dict(params)
    for name, (mean, var) in rec.moments.items():
        out[f"{name}.mean"], out[f"{name}.var"] = mean.contiguous(), var.contiguous()
    return out

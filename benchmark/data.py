"""Synthetic meshes made on the device from the seed.

Each mesh is a random smooth genus-0 surface on the level-s icosphere:
radius r(x) = 1 + the sum of six bumps amp·sin(freq·pi·(x·d) + phase), with
d a random unit direction, freq U(1, 3), phase U(0, 2pi), amp U(0.02, 0.12),
then scaled so that its largest radius is U(0.5, 0.9). The recipe is the
program's ``data/datasets.py:synthetic_vertices``, drawn here from one
``torch.Generator`` on the card in a few large calls, all meshes at once.

The training target of a mesh is its (V, 9) rows [position | unit
area-weighted vertex normal | umbrella Laplacian]; the network input is the
position grid (5·2^s, 2^(s+1), 3), the vertices without the poles.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import loss as L


def vertices(s: int, n: int, seed: int, device, chunk: int = 256) -> torch.Tensor:
    """(n, V, 3) float32 mesh vertices."""
    base = torch.from_numpy(geo.vertex_coords(s)).float().to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn(n, 6, 3, generator=gen, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    u = torch.rand(n, 6, 3, generator=gen, device=device)
    freq, phase, amp = 1.0 + 2.0 * u[..., 0], 2.0 * math.pi * u[..., 1], 0.02 + 0.10 * u[..., 2]
    scale = 0.5 + 0.4 * torch.rand(n, generator=gen, device=device)
    out = torch.empty(n, base.shape[0], 3, device=device)
    for i in range(0, n, chunk):
        j = min(n, i + chunk)
        arg = freq[i:j, :, None] * math.pi * (d[i:j] @ base.T) + phase[i:j, :, None]
        r = 1.0 + (amp[i:j, :, None] * torch.sin(arg)).sum(dim=1)
        k = scale[i:j] / r.abs().amax(dim=1)
        out[i:j] = (k[:, None] * r)[..., None] * base
    return out


def grids(v: torch.Tensor, s: int) -> torch.Tensor:
    """(n, V, 3) vertices -> (n, 5·2^s, 2^(s+1), 3) input grids."""
    H, W = geo.grid_shape(s)
    return v[:, :-2].reshape(v.shape[0], H, W, 3).contiguous()


def targets(v: torch.Tensor, s: int, chunk: int = 128) -> torch.Tensor:
    """(n, V, 3) vertices -> (n, V, 9) [position | normal | Laplacian]."""
    out = torch.empty(*v.shape[:2], 9, device=v.device)
    for i in range(0, v.shape[0], chunk):
        vi = v[i : i + chunk]
        out[i : i + chunk] = torch.cat([vi, L.vertex_normals(vi, s), L.laplacian(vi, s)], dim=-1)
    return out

"""The published training losses in plain float32 PyTorch: the AE's
position MSE, the VAE's P2P loss (positions, vertex normals, umbrella
Laplacian) plus the KL divergence, over vertex lists built from the grid.

Normals and the Laplacian take the vertex tables of
``reference/geometry.py`` (incident faces, mesh neighbours) as gathers.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference import geometry as geo

SAFE_EPS = 1e-10


def grid_to_vertices(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, 5h, w, C) grid -> (B, V, C): the cells row-major, then the north
    pole (mean of the charts' (0, 0) cells) and the south pole (mean of
    their (h-1, w-1) cells)."""
    h, w = geo.chart_shape(s)
    B, _, _, C = x.shape
    xc = x.reshape(B, 5, h, w, C)
    north = xc[:, :, 0, 0, :].mean(dim=1, keepdim=True)
    south = xc[:, :, h - 1, w - 1, :].mean(dim=1, keepdim=True)
    return torch.cat([x.reshape(B, 5 * h * w, C), north, south], dim=1)


@functools.lru_cache(maxsize=None)
def _tables(s: int, device: str):
    fidx, fmask = geo.vertex_face_table(s)
    nbrs, nmask = geo.neighbor_table(s)

    def on(a, dtype=None):
        t = torch.from_numpy(a).to(device)
        return t if dtype is None else t.to(dtype)

    return {"faces": on(geo.faces(s)), "fidx": on(fidx), "fmask": on(fmask, torch.float32),
            "nbrs": on(nbrs), "nmask": on(nmask, torch.float32)}


def safe_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min((x * x).sum(dim=-1, keepdim=keepdim), SAFE_EPS**2))


def vertex_normals(v: torch.Tensor, s: int) -> torch.Tensor:
    """(B, V, 3) -> unit area-weighted vertex normals."""
    t = _tables(s, str(v.device))
    f = t["faces"]
    p0, p1, p2 = v[:, f[:, 0]], v[:, f[:, 1]], v[:, f[:, 2]]
    fn = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    vn = (fn[:, t["fidx"]] * t["fmask"][None, :, :, None]).sum(dim=2)
    return vn / safe_norm(vn)


def laplacian(v: torch.Tensor, s: int) -> torch.Tensor:
    """(B, V, C) -> mean of the mesh neighbours minus the vertex."""
    t = _tables(s, str(v.device))
    deg = t["nmask"].sum(dim=1)
    mean = (v[:, t["nbrs"]] * t["nmask"][None, :, :, None]).sum(dim=2) / deg[None, :, None]
    return mean - v


def position_mse(v: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error of (B, V, 3) positions."""
    return ((v - target[..., 0:3]) ** 2).mean(dim=(1, 2))


def p2p(v: torch.Tensor, target: torch.Tensor, s: int, factors) -> torch.Tensor:
    """Batch mean of f_pos·MSE(positions) + f_nor·mean(1 - cos(normals)) +
    f_lap·MSE(Laplacian), each term per sample; a term whose factor is 0
    is left out."""
    per = factors["pos"] * position_mse(v, target)
    if factors["nor"]:
        a, b = vertex_normals(v, s), target[..., 3:6]
        cos = (a * b).sum(dim=-1) / (safe_norm(a, False) * safe_norm(b, False))
        per = per + factors["nor"] * (1.0 - cos).mean(dim=1)
    if factors["lap"]:
        per = per + factors["lap"] * ((laplacian(v, s) - target[..., 6:9]) ** 2).mean(dim=(1, 2))
    return per.mean()


def kld(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Batch mean of -0.5·mean over the latent of (1 + logvar - mu² - e^logvar)."""
    mu = mu.reshape(mu.shape[0], -1)
    logvar = logvar.reshape(logvar.shape[0], -1)
    return (-0.5 * (1.0 + logvar - mu**2 - torch.exp(logvar)).mean(dim=1)).mean()

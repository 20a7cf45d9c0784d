"""Numpy mesh helpers the datasets need (normals and umbrella Laplacian).

Ports of ``geniconet_tpu/ops/mesh_math.py:vertex_normals_numpy`` and
``laplacian_numpy``, which live in a module that imports JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = ["vertex_normals_numpy", "laplacian_numpy"]

_EPS = 1e-10


def vertex_normals_numpy(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V, 3) area-weighted unit vertex normals of one mesh."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    vn = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    mag = np.clip(np.sqrt((vn**2).sum(axis=1)), _EPS, None)[:, None]
    return vn / mag


def laplacian_numpy(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V, C) umbrella Laplacian of one mesh: mean of the neighbours minus self."""
    nbr_sets: list[set[int]] = [set() for _ in range(vertices.shape[0])]
    for a, b, c in faces:
        nbr_sets[a].update((b, c))
        nbr_sets[b].update((a, c))
        nbr_sets[c].update((a, b))
    out = np.zeros_like(vertices)
    for i, s in enumerate(nbr_sets):
        out[i] = vertices[sorted(s)].mean(axis=0) - vertices[i]
    return out

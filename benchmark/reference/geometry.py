"""Icosahedral grid geometry, numpy only: chart shapes, vertex coordinates,
faces and the vertex tables the reference loss and the benchmark's data
read.

Chart ``c`` of the unfolded icosahedron is parameterised by ``(i, j)``,
``i in [0, 2^s]``, ``j in [0, 2^(s+1)]``; it stores ``i in [1, 2^s]``,
``j in [0, 2^(s+1) - 1]`` as a dense ``(2^s, 2^(s+1))`` grid, so the public
``(5·2^s, 2^(s+1))`` grid flattened row-major gives vertex ids ``0..N-1``
(``N = 10·4^s``); the north pole is vertex N, the south pole N+1. Seam
points a chart does not store resolve to chart ``c+1``. Coordinates come
from recursive midpoint subdivision of the base icosahedron, re-projected
onto the unit sphere. ``V = 10·4^s + 2``, ``F = 20·4^s``.
"""

from __future__ import annotations

import functools

import numpy as np

NUM_CHARTS = 5


def chart_shape(s: int) -> tuple[int, int]:
    """(h, w) = (2^s, 2^(s+1)) of one chart's stored grid."""
    return 1 << s, 1 << (s + 1)


def grid_shape(s: int) -> tuple[int, int]:
    """(H, W) = (5·2^s, 2^(s+1)) of the public grid."""
    h, w = chart_shape(s)
    return NUM_CHARTS * h, w


def num_vertices(s: int) -> int:
    return 10 * 4**s + 2


def grid_cells(s: int) -> int:
    """Grid cells at level s: every vertex but the two poles."""
    return 10 * 4**s


def _base_icosahedron() -> np.ndarray:
    """(12, 3): u_0..u_4 at latitude atan(1/2), l_0..l_4 at -atan(1/2) and
    36 degrees further round, then the north and the south pole."""
    lat = np.arctan(0.5)
    verts = np.zeros((12, 3), dtype=np.float64)
    for c in range(5):
        lon_u = 2.0 * np.pi * c / 5.0
        lon_l = 2.0 * np.pi * (c + 0.5) / 5.0
        verts[c] = [np.cos(lat) * np.cos(lon_u), np.cos(lat) * np.sin(lon_u), np.sin(lat)]
        verts[5 + c] = [np.cos(lat) * np.cos(lon_l), np.cos(lat) * np.sin(lon_l), -np.sin(lat)]
    verts[10] = [0.0, 0.0, 1.0]
    verts[11] = [0.0, 0.0, -1.0]
    return verts


def _resolve(s: int, c: int, i: int, j: int) -> int:
    """Global vertex id of chart c's parameter point (i, j)."""
    h = 1 << s
    w = 2 * h
    if i == 0 and j == 0:
        return num_vertices(s) - 2
    if i == h and j == w:
        return num_vertices(s) - 1
    if i == 0:
        if j <= h:
            return _resolve(s, (c + 1) % 5, j, 0)
        return _resolve(s, (c + 1) % 5, h, j - h)
    if j == w:
        return _resolve(s, (c + 1) % 5, h, h + i)
    return c * h * w + (i - 1) * w + j


@functools.lru_cache(maxsize=None)
def _param_ids(s: int) -> np.ndarray:
    h, w = chart_shape(s)
    out = np.empty((NUM_CHARTS, h + 1, w + 1), dtype=np.int64)
    for c in range(NUM_CHARTS):
        for i in range(h + 1):
            for j in range(w + 1):
                out[c, i, j] = _resolve(s, c, i, j)
    return out


@functools.lru_cache(maxsize=None)
def _param_coords(s: int) -> np.ndarray:
    """(5, h+1, w+1, 3) unit-sphere coordinates of every parameter point."""
    base = _base_icosahedron()
    u, lo, n, sp = base[0:5], base[5:10], base[10], base[11]
    grids = np.empty((NUM_CHARTS, 2, 3, 3), dtype=np.float64)
    for c in range(NUM_CHARTS):
        c1 = (c + 1) % 5
        grids[c, 0, 0], grids[c, 1, 0], grids[c, 0, 1] = n, u[c], u[c1]
        grids[c, 1, 1], grids[c, 0, 2], grids[c, 1, 2] = lo[c], lo[c1], sp

    def norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    for _ in range(s):
        _, hi, wi, _ = grids.shape
        out = np.empty((NUM_CHARTS, 2 * hi - 1, 2 * wi - 1, 3), dtype=np.float64)
        out[:, 0::2, 0::2] = grids
        out[:, 1::2, 0::2] = norm(grids[:, :-1, :] + grids[:, 1:, :])
        out[:, 0::2, 1::2] = norm(grids[:, :, :-1] + grids[:, :, 1:])
        out[:, 1::2, 1::2] = norm(grids[:, 1:, :-1] + grids[:, :-1, 1:])
        grids = out
    return grids


@functools.lru_cache(maxsize=None)
def vertex_coords(s: int) -> np.ndarray:
    """(V, 3) float64 unit-sphere positions in storage order, poles last."""
    h, w = chart_shape(s)
    stored = _param_coords(s)[:, 1:, :-1, :].reshape(NUM_CHARTS * h * w, 3)
    base = _base_icosahedron()
    return np.concatenate([stored, base[10:12]], axis=0)


@functools.lru_cache(maxsize=None)
def faces(s: int) -> np.ndarray:
    """(F, 3) int64 triangles, oriented outward."""
    ids = _param_ids(s)
    tris = []
    for c in range(NUM_CHARTS):
        a = ids[c]
        tris.append(np.stack([a[:-1, :-1].ravel(), a[1:, :-1].ravel(), a[:-1, 1:].ravel()], 1))
        tris.append(np.stack([a[1:, :-1].ravel(), a[1:, 1:].ravel(), a[:-1, 1:].ravel()], 1))
    f = np.concatenate(tris, axis=0)
    v = vertex_coords(s)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    if np.einsum("ij,ij->i", p0, np.cross(p1 - p0, p2 - p0)).sum() < 0:
        f = f[:, ::-1]
    return np.ascontiguousarray(f)


def _table(rows: np.ndarray, cols: np.ndarray, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Group ``cols`` by ``rows`` into an (n_rows, 6) table and its mask,
    each row's entries in ascending order of ``cols``."""
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n_rows)
    if counts.max() > 6:
        raise ValueError("a vertex with more than 6 entries")
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    table = np.zeros((n_rows, 6), np.int64)
    mask = np.zeros((n_rows, 6), bool)
    table[rows, slot] = cols
    mask[rows, slot] = True
    return table, mask


@functools.lru_cache(maxsize=None)
def vertex_face_table(s: int) -> tuple[np.ndarray, np.ndarray]:
    """Incident faces of every vertex: (V, 6) face ids and mask (5 faces at
    the 12 base vertices)."""
    f = faces(s)
    rows = f.reshape(-1)
    cols = np.repeat(np.arange(f.shape[0]), 3)
    return _table(rows, cols, num_vertices(s))


@functools.lru_cache(maxsize=None)
def neighbor_table(s: int) -> tuple[np.ndarray, np.ndarray]:
    """Mesh neighbours of every vertex: (V, 6) vertex ids and mask."""
    f = faces(s)
    a = np.concatenate([f[:, 0], f[:, 1], f[:, 2], f[:, 1], f[:, 2], f[:, 0]])
    b = np.concatenate([f[:, 1], f[:, 2], f[:, 0], f[:, 0], f[:, 1], f[:, 2]])
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return _table(pairs[:, 0], pairs[:, 1], num_vertices(s))

"""Icosahedral grid geometry: chart shapes, vertex coordinates, faces, patch ids.

The port's own copy of the parts of ``geniconet_tpu/geometry/ico.py`` that
it uses (numpy only); the tests hold its tables equal to that module's.

Chart ``c`` of the unfolded icosahedron is parameterized by integer
coordinates ``(i, j)``, ``i ∈ [0, 2^s]``, ``j ∈ [0, 2^(s+1)]``; its six
corners are the base vertices n, u_c, u_{c+1}, l_c, l_{c+1}, s. Chart ``c``
stores the points ``i ∈ [1, 2^s]``, ``j ∈ [0, 2^(s+1)-1]`` as a dense
``(2^s, 2^(s+1))`` grid, so flattening the public ``(5·2^s, 2^(s+1))`` grid
row-major gives vertex ids ``0..N-1`` with ``N = 10·4^s``; the north pole is
vertex N and the south pole N+1. Seam points not stored by chart ``c``
resolve to chart ``c+1``'s storage. Coordinates come from recursive midpoint
subdivision of the base icosahedron with re-projection onto the unit sphere.

Counts at subdivision ``s``: ``V = 10·4^s + 2``, ``F = 20·4^s``.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "num_vertices",
    "num_faces",
    "chart_shape",
    "grid_shape",
    "get_ico_faces",
    "get_vertex_coords",
    "get_patch_ids",
    "get_neighbor_table",
    "get_vertex_face_table",
    "base_icosahedron",
]

NUM_CHARTS = 5


def chart_shape(subdivisions: int) -> tuple[int, int]:
    """(h, w) of one chart's stored grid: h = 2^s rows, w = 2^(s+1) cols."""
    return 1 << subdivisions, 1 << (subdivisions + 1)


def grid_shape(subdivisions: int) -> tuple[int, int]:
    """(H, W) of the public stacked grid tensor: H = 5·2^s, W = 2^(s+1)."""
    h, w = chart_shape(subdivisions)
    return NUM_CHARTS * h, w


def num_vertices(subdivisions: int) -> int:
    """V = 10·4^s + 2 (grid vertices + 2 poles)."""
    return 10 * 4**subdivisions + 2


def num_faces(subdivisions: int) -> int:
    """F = 20·4^s."""
    return 20 * 4**subdivisions


def north_pole_index(subdivisions: int) -> int:
    return num_vertices(subdivisions) - 2


def south_pole_index(subdivisions: int) -> int:
    return num_vertices(subdivisions) - 1


def base_icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Base icosahedron as (vertices (12, 3), rings layout).

    Vertex order: ``[u_0..u_4, l_0..l_4, n, s]`` so that subdivision-0 ids
    follow the same "poles last" convention as every other level.

    ``u_c`` sits at longitude ``72°·c`` and latitude ``atan(1/2)``;
    ``l_c`` at longitude ``72°·c + 36°`` and latitude ``−atan(1/2)``.
    """
    lat = np.arctan(0.5)
    verts = np.zeros((12, 3), dtype=np.float64)
    for c in range(5):
        lon_u = 2.0 * np.pi * c / 5.0
        lon_l = 2.0 * np.pi * (c + 0.5) / 5.0
        verts[c] = [np.cos(lat) * np.cos(lon_u), np.cos(lat) * np.sin(lon_u), np.sin(lat)]
        verts[5 + c] = [np.cos(lat) * np.cos(lon_l), np.cos(lat) * np.sin(lon_l), -np.sin(lat)]
    verts[10] = [0.0, 0.0, 1.0]   # north pole n
    verts[11] = [0.0, 0.0, -1.0]  # south pole s
    return verts, np.array([10, 11], dtype=np.int64)


def _resolve_param(subdivisions: int, c: int, i: int, j: int) -> int:
    """Map chart-``c`` parameter point ``(i, j)`` to its global vertex id."""
    h = 1 << subdivisions
    w = h * 2
    if i == 0 and j == 0:
        return north_pole_index(subdivisions)
    if i == h and j == w:
        return south_pole_index(subdivisions)
    if i == 0:
        if j <= h:
            return _resolve_param(subdivisions, (c + 1) % 5, j, 0)
        return _resolve_param(subdivisions, (c + 1) % 5, h, j - h)
    if j == w:
        return _resolve_param(subdivisions, (c + 1) % 5, h, h + i)
    # owned by chart c: i in [1, h], j in [0, w-1]
    return c * h * w + (i - 1) * w + j


@functools.lru_cache(maxsize=None)
def _param_id_grid(subdivisions: int) -> np.ndarray:
    """(5, h+1, w+1) int64: global vertex id of every chart parameter point."""
    h, w = chart_shape(subdivisions)
    out = np.empty((NUM_CHARTS, h + 1, w + 1), dtype=np.int64)
    for c in range(NUM_CHARTS):
        for i in range(h + 1):
            for j in range(w + 1):
                out[c, i, j] = _resolve_param(subdivisions, c, i, j)
    return out


@functools.lru_cache(maxsize=None)
def get_ico_faces(subdivisions: int) -> np.ndarray:
    """Triangle faces (20·4^s, 3) int64, consistently outward-oriented.

    Behavioral contract of reference ``icocnn.utils.ico_geometry.get_ico_faces``
    (usage: reference losses.py:34-39, run.py:144): indexes ``10·4^s + 2``
    vertices with poles last.
    """
    h, w = chart_shape(subdivisions)
    ids = _param_id_grid(subdivisions)
    faces = []
    for c in range(NUM_CHARTS):
        a = ids[c]
        # upper triangles: (i, j), (i+1, j), (i, j+1)
        up = np.stack(
            [a[:-1, :-1].ravel(), a[1:, :-1].ravel(), a[:-1, 1:].ravel()], axis=1
        )
        # lower triangles: (i+1, j), (i+1, j+1), (i, j+1)
        lo = np.stack(
            [a[1:, :-1].ravel(), a[1:, 1:].ravel(), a[:-1, 1:].ravel()], axis=1
        )
        faces.append(up)
        faces.append(lo)
    f = np.concatenate(faces, axis=0)
    assert f.shape == (num_faces(subdivisions), 3)
    # fix global orientation so face normals point outward (positive volume)
    v = get_vertex_coords(subdivisions)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    vol = np.einsum("ij,ij->i", p0, np.cross(p1 - p0, p2 - p0)).sum() / 6.0
    if vol < 0:
        f = f[:, ::-1]
    return np.ascontiguousarray(f)


@functools.lru_cache(maxsize=None)
def _chart_param_coords(subdivisions: int) -> np.ndarray:
    """(5, h+1, w+1, 3) float64 unit-sphere coords of all parameter points.

    Recursive midpoint subdivision: start from the chart corner layout at
    s = 0 and repeatedly insert re-normalized edge midpoints (row edges,
    col edges, and the cell anti-diagonal (i+1, j)—(i, j+1)).
    """
    base, _ = base_icosahedron()
    u = base[0:5]
    l = base[5:10]
    n = base[10]
    s_pole = base[11]
    # s=0 chart param grid is (2, 3): rows i∈{0,1}, cols j∈{0,1,2}
    grids = np.empty((NUM_CHARTS, 2, 3, 3), dtype=np.float64)
    for c in range(NUM_CHARTS):
        c1 = (c + 1) % 5
        grids[c, 0, 0] = n
        grids[c, 1, 0] = u[c]
        grids[c, 0, 1] = u[c1]
        grids[c, 1, 1] = l[c]
        grids[c, 0, 2] = l[c1]
        grids[c, 1, 2] = s_pole

    def norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    for _ in range(subdivisions):
        _, hi, wi, _ = grids.shape
        out = np.empty((NUM_CHARTS, 2 * hi - 1, 2 * wi - 1, 3), dtype=np.float64)
        out[:, 0::2, 0::2] = grids
        out[:, 1::2, 0::2] = norm(grids[:, :-1, :] + grids[:, 1:, :])
        out[:, 0::2, 1::2] = norm(grids[:, :, :-1] + grids[:, :, 1:])
        out[:, 1::2, 1::2] = norm(grids[:, 1:, :-1] + grids[:, :-1, 1:])
        grids = out
    return grids


@functools.lru_cache(maxsize=None)
def get_vertex_coords(subdivisions: int) -> np.ndarray:
    """(V, 3) float64 unit-sphere vertex positions, storage order (poles last)."""
    h, w = chart_shape(subdivisions)
    grids = _chart_param_coords(subdivisions)
    stored = grids[:, 1:, :-1, :]  # (5, h, w, 3): param i∈[1..h], j∈[0..w-1]
    coords = stored.reshape(NUM_CHARTS * h * w, 3)
    base, _ = base_icosahedron()
    return np.concatenate([coords, base[10:11], base[11:12]], axis=0)


@functools.lru_cache(maxsize=None)
def get_neighbor_table(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense vertex adjacency: (neighbors (V, 6) int64, mask (V, 6) bool).

    Derived from the face table, neighbours in ascending order. Degree is 6
    everywhere except the 12 base icosahedron vertices (degree 5); their
    6th slot holds vertex 0 with ``mask=False``."""
    V = num_vertices(subdivisions)
    nbr_sets: list[set[int]] = [set() for _ in range(V)]
    for a, b, c in get_ico_faces(subdivisions):
        nbr_sets[a].update((b, c))
        nbr_sets[b].update((a, c))
        nbr_sets[c].update((a, b))
    nbrs = np.zeros((V, 6), dtype=np.int64)
    mask = np.zeros((V, 6), dtype=bool)
    for v_id, s in enumerate(nbr_sets):
        lst = sorted(s)
        nbrs[v_id, : len(lst)] = lst
        mask[v_id, : len(lst)] = True
    return nbrs, mask


@functools.lru_cache(maxsize=None)
def get_vertex_face_table(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """Incident faces per vertex in face order: (face_idx (V, 6) int64,
    mask (V, 6) bool); 6 faces per vertex, 5 for the 12 base vertices."""
    V = num_vertices(subdivisions)
    lists: list[list[int]] = [[] for _ in range(V)]
    for f_id, (a, b, c) in enumerate(get_ico_faces(subdivisions)):
        lists[a].append(f_id)
        lists[b].append(f_id)
        lists[c].append(f_id)
    idx = np.zeros((V, 6), dtype=np.int64)
    mask = np.zeros((V, 6), dtype=bool)
    for v_id, lst in enumerate(lists):
        idx[v_id, : len(lst)] = lst
        mask[v_id, : len(lst)] = True
    return idx, mask


@functools.lru_cache(maxsize=None)
def get_patch_ids(subdivisions: int) -> np.ndarray:
    """(V,) int64 chart/patch id per vertex; poles get ids 5 (north), 6 (south).

    Parity with the app's patch layout: 5 patches of ``2^s × 2^(s+1)`` grid
    vertices (reference app.py:1506-1515).
    """
    h, w = chart_shape(subdivisions)
    ids = np.repeat(np.arange(NUM_CHARTS, dtype=np.int64), h * w)
    return np.concatenate([ids, np.array([5, 6], dtype=np.int64)])

"""Differentiable mesh math for the training loss: vertex normals and the
umbrella Laplacian, and their numpy twins for the datasets.

Port of ``geniconet_tpu/ops/mesh_math.py``. Two forms compute the same
values (the tests hold them equal):

* vertex-table forms (``vertex_normals``, ``laplacian``): face normals from
  three face-corner gathers and a cross product, summed per vertex over the
  ``(V, 6)`` incident-face table; the umbrella Laplacian over the ``(V, 6)``
  neighbour table. Each gather is an autograd Function whose backward is a
  gather over a precomputed inverse-incidence table (the JAX package's
  custom VJPs): no ``index_add``, so the backward has no atomics and gives
  the same bits on every run on the card.
* grid-stencil forms (``vertex_normals_grid``, ``laplacian_grid``), the
  loss's default: every non-pole vertex is a grid cell whose mesh
  neighbours sit at fixed hex offsets of the ``ico_pad`` halo, so both ops
  are static slices and elementwise math. The per-tap and per-pair masks
  are derived when the tables are built, from ``padded_index_map`` crossed
  with the face list, and each cell's neighbours and faces are asserted
  equal to the mesh's there.

Float32 math whatever the input dtype. Normals are area-weighted and
normalised with ``safe_norm`` (reference generate.py:20-43).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from geniconet_tpu_torch.geometry import ico

__all__ = [
    "safe_norm", "face_normals", "vertex_normals", "laplacian", "vertex_normals_grid",
    "laplacian_grid", "vertex_normals_numpy", "laplacian_numpy",
]

_EPS = 1e-10


# ---------------------------------------------------------------------------
# gather-transpose tables and the gathers whose backward is a gather
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gather_transpose_tables(subdivisions: int) -> dict:
    """Inverse-incidence tables (numpy, cached per level).

    fc_inv/fc_mask (V, 6): flat indices ``face*3 + corner`` of every (face,
        corner) that holds vertex v: the transpose of the face-corner takes.
    vf_inv (F, 3): flat indices ``vertex*6 + j`` of the 3 unmasked
        incident-face slots that hold face f: the transpose of the masked
        incident-face gather.
    nb_inv/nb_mask (V, 6): flat indices ``vertex*6 + j`` of the unmasked
        neighbour slots that hold vertex u (adjacency is symmetric): the
        transpose of the masked neighbour gather.
    """
    V = ico.num_vertices(subdivisions)
    faces = ico.get_ico_faces(subdivisions)
    F = faces.shape[0]
    fidx, fmask = ico.get_vertex_face_table(subdivisions)
    nbrs, nmask = ico.get_neighbor_table(subdivisions)

    fc_inv = np.zeros((V, 6), np.int64)
    fc_mask = np.zeros((V, 6), np.float32)
    cnt = np.zeros(V, np.int64)
    for f_id, tri in enumerate(faces):
        for k in range(3):
            u = int(tri[k])
            fc_inv[u, cnt[u]] = f_id * 3 + k
            fc_mask[u, cnt[u]] = 1.0
            cnt[u] += 1
    assert cnt.max() <= 6

    vf_inv = np.zeros((F, 3), np.int64)
    cnt = np.zeros(F, np.int64)
    for v_id in range(V):
        for j in range(6):
            if fmask[v_id, j]:
                f_id = int(fidx[v_id, j])
                vf_inv[f_id, cnt[f_id]] = v_id * 6 + j
                cnt[f_id] += 1
    assert (cnt == 3).all()

    nb_inv = np.zeros((V, 6), np.int64)
    nb_mask = np.zeros((V, 6), np.float32)
    cnt = np.zeros(V, np.int64)
    for v_id in range(V):
        for j in range(6):
            if nmask[v_id, j]:
                u = int(nbrs[v_id, j])
                nb_inv[u, cnt[u]] = v_id * 6 + j
                nb_mask[u, cnt[u]] = 1.0
                cnt[u] += 1
    assert cnt.max() <= 6

    return {"fc_inv": fc_inv, "fc_mask": fc_mask, "vf_inv": vf_inv, "nb_inv": nb_inv,
            "nb_mask": nb_mask}


@functools.lru_cache(maxsize=None)
def _tables_on(subdivisions: int, device: str) -> dict:
    """The gather tables and their inverses as tensors on ``device``."""
    t = dict(_gather_transpose_tables(subdivisions))
    t["faces"] = ico.get_ico_faces(subdivisions)
    t["fidx"], fmask = ico.get_vertex_face_table(subdivisions)
    t["nbrs"], nmask = ico.get_neighbor_table(subdivisions)
    t["fmask"], t["nmask"] = fmask.astype(np.float32), nmask.astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in t.items()}


def _masked_gather_sum(g, inv, mask=None):
    """Σ_j mask[u, j]·g[:, inv[u, j]] over the slots j of each row u:
    g (B, N, C), inv (U, S) -> (B, U, C)."""
    got = g[:, inv]
    if mask is not None:
        got = got * mask[None, :, :, None]
    return got.sum(dim=2)


class _FaceCornerTakes(torch.autograd.Function):
    """(B, V, 3) -> the three (B, F, 3) face-corner gathers; the backward
    gathers each vertex's (face, corner) slots."""

    @staticmethod
    def forward(ctx, v, subdivisions):
        t = _tables_on(subdivisions, str(v.device))
        ctx.tables = t
        return tuple(v[:, t["faces"][:, k]] for k in range(3))

    @staticmethod
    def backward(ctx, g0, g1, g2):
        t = ctx.tables
        B, F, C = g0.shape
        cat = torch.stack([g0, g1, g2], dim=2).reshape(B, 3 * F, C)
        return _masked_gather_sum(cat, t["fc_inv"], t["fc_mask"]), None


class _VfMaskedTake(torch.autograd.Function):
    """(B, F, 3) face values -> (B, V, 6, 3) masked incident-face gather;
    the backward gathers each face's 3 table slots."""

    @staticmethod
    def forward(ctx, fn, subdivisions):
        t = _tables_on(subdivisions, str(fn.device))
        ctx.tables = t
        return fn[:, t["fidx"]] * t["fmask"][None, :, :, None]

    @staticmethod
    def backward(ctx, g):
        B, V, S, C = g.shape
        return _masked_gather_sum(g.reshape(B, V * S, C), ctx.tables["vf_inv"]), None


class _NbrMaskedTake(torch.autograd.Function):
    """(B, V, C) -> (B, V, 6, C) masked neighbour gather; the backward rides
    the symmetric adjacency's inverse table."""

    @staticmethod
    def forward(ctx, x, subdivisions):
        t = _tables_on(subdivisions, str(x.device))
        ctx.tables = t
        return x[:, t["nbrs"]] * t["nmask"][None, :, :, None]

    @staticmethod
    def backward(ctx, g):
        t = ctx.tables
        B, V, S, C = g.shape
        return _masked_gather_sum(g.reshape(B, V * S, C), t["nb_inv"], t["nb_mask"]), None


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True,
              eps: float = _EPS) -> torch.Tensor:
    """eps-floored L2 norm with a finite gradient at zero vectors: the
    squared sum is clamped inside the sqrt (a clamp outside it would pass
    the norm's NaN gradient at 0 through)."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp_min(sq, eps * eps))


def face_normals(v: torch.Tensor, faces, normalize: bool = False) -> torch.Tensor:
    """(B, V, 3), (F, 3) -> (B, F, 3), area-weighted unless ``normalize``."""
    faces = torch.as_tensor(faces, device=v.device)
    p0, p1, p2 = (v[:, faces[:, k]] for k in range(3))
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    return n / safe_norm(n) if normalize else n


def vertex_normals(v: torch.Tensor, subdivisions: int) -> torch.Tensor:
    """(B, V, 3) vertices -> (B, V, 3) unit area-weighted vertex normals."""
    p0, p1, p2 = _FaceCornerTakes.apply(v.float(), subdivisions)
    fn = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    vn = _VfMaskedTake.apply(fn, subdivisions).sum(dim=2)
    return vn / safe_norm(vn)


def laplacian(v: torch.Tensor, subdivisions: int) -> torch.Tensor:
    """(B, V, C) signal -> (B, V, C) umbrella Laplacian (mean of the
    neighbours minus self)."""
    v = v.float()
    _, mask = ico.get_neighbor_table(subdivisions)
    deg = torch.from_numpy(mask.sum(axis=1).astype(np.float32)).to(v.device)
    mean_nbr = _NbrMaskedTake.apply(v, subdivisions).sum(dim=2) / deg[None, :, None]
    return mean_nbr - v


# ---------------------------------------------------------------------------
# grid-stencil forms (static slices of the halo; the loss's default)
# ---------------------------------------------------------------------------

# the 6 hex-neighbour offsets of the 3x3 stencil (corners (-1,-1)/(1,1)
# masked), in cyclic order around the centre so consecutive pairs are faces
_HEX_OFFS = ((-1, 0), (-1, 1), (0, 1), (1, 0), (1, -1), (0, -1))


@functools.lru_cache(maxsize=None)
def _grid_stencil_tables(subdivisions: int) -> dict:
    """Static masks of the grid-stencil forms (numpy, cached per level):

      lap_mask (6, 5, h, w, 1) f32: tap i is a real, non-duplicate mesh
               neighbour of the cell (degree-5 cells mask one tap);
      deg      (5, h, w, 1) f32: the cell's mesh degree;
      pair_masks {(i, j): (5, h, w, 1) f32}: the ordered tap pair (i, j)
               forms an incident face (x, nbr_i, nbr_j) in the mesh's outward
               orientation, every incident face claimed exactly once;
      pole_pairs (north, south): chart pairs (ci, cj) such that (pole,
               corner_ci, corner_cj) is an oriented face.
    """
    from geniconet_tpu_torch.ops.pad import MASKED, NORTH_SYNTH, SOUTH_SYNTH, padded_index_map

    h, w = ico.chart_shape(subdivisions)
    V = ico.num_vertices(subdivisions)
    npole, spole = V - 2, V - 1
    pim = padded_index_map(subdivisions)
    idmap = np.where(pim == NORTH_SYNTH, npole, np.where(pim == SOUTH_SYNTH, spole, pim))
    nbr = np.stack([idmap[:, 1 + di : 1 + di + h, 1 + dj : 1 + dj + w] for di, dj in _HEX_OFFS])
    masked = np.stack([pim[:, 1 + di : 1 + di + h, 1 + dj : 1 + dj + w] == MASKED
                       for di, dj in _HEX_OFFS])
    ctr = idmap[:, 1 : 1 + h, 1 : 1 + w]

    oriented, edges = set(), set()
    n_inc = np.zeros(V, np.int64)
    true_nbrs: list[set] = [set() for _ in range(V)]
    for f in ico.get_ico_faces(subdivisions):
        a, b, c = int(f[0]), int(f[1]), int(f[2])
        oriented.update(((a, b, c), (b, c, a), (c, a, b)))
        for u, v_ in ((a, b), (b, c), (c, a)):
            edges.update(((u, v_), (v_, u)))
            true_nbrs[u].add(v_)
            true_nbrs[v_].add(u)
        n_inc[[a, b, c]] += 1

    lap_mask = np.zeros((6, 5, h, w), np.float32)
    deg = np.zeros((5, h, w), np.float32)
    pair_masks: dict = {}
    # candidate order: cyclic-consecutive pairs (the interior case), then
    # gap-bridging pairs, then every other pair
    candidates = [(i, (i + 1) % 6) for i in range(6)]
    candidates += [(i, (i + 2) % 6) for i in range(6)]
    candidates += [(i, j) for i in range(6) for j in range(6)
                   if i != j and (i, j) not in candidates]
    for c in range(5):
        for r in range(h):
            for q in range(w):
                x = int(ctr[c, r, q])
                ns = [int(nbr[i, c, r, q]) for i in range(6)]
                ok = [not masked[i, c, r, q] for i in range(6)]
                seen: set = set()
                for i in range(6):
                    if ok[i] and (x, ns[i]) in edges and ns[i] not in seen:
                        lap_mask[i, c, r, q] = 1.0
                        seen.add(ns[i])
                if seen != true_nbrs[x]:
                    raise AssertionError(f"s={subdivisions} cell {(c, r, q)} (v{x}): stencil "
                                         f"neighbours {sorted(seen)} != mesh "
                                         f"{sorted(true_nbrs[x])}")
                deg[c, r, q] = float(len(seen))
                claimed: set = set()
                for i, j in candidates:
                    if not (ok[i] and ok[j]):
                        continue
                    tri = (x, ns[i], ns[j])
                    key = frozenset(tri)
                    if tri in oriented and key not in claimed:
                        pair_masks.setdefault((i, j), np.zeros((5, h, w), np.float32))[c, r, q] = 1
                        claimed.add(key)
                if len(claimed) != n_inc[x]:
                    raise AssertionError(f"s={subdivisions} cell {(c, r, q)} (v{x}): claimed "
                                         f"{len(claimed)} faces, mesh has {n_inc[x]}")

    def pole_ring(pole, corner_ids):
        pairs = tuple((ci, cj) for ci, a in enumerate(corner_ids)
                      for cj, b in enumerate(corner_ids) if ci != cj and (pole, a, b) in oriented)
        assert len(pairs) == 5, (pole, pairs)
        return pairs

    north_corners = [c * h * w for c in range(5)]
    south_corners = [c * h * w + (h - 1) * w + (w - 1) for c in range(5)]
    return {
        "lap_mask": lap_mask[..., None],
        "deg": deg[..., None],
        "pair_masks": {k: v[..., None] for k, v in pair_masks.items()},
        "pole_pairs": (pole_ring(npole, north_corners), pole_ring(spole, south_corners)),
    }


@functools.lru_cache(maxsize=None)
def _stencil_on(subdivisions: int, device: str) -> dict:
    """The stencil masks as tensors on ``device`` (pair masks in table order)."""
    t = _grid_stencil_tables(subdivisions)

    def on(a):
        return torch.from_numpy(a).to(device)

    return {"lap_mask": on(t["lap_mask"]), "deg": on(t["deg"]),
            "pair_masks": [(k, on(m)) for k, m in t["pair_masks"].items()],
            "pole_pairs": t["pole_pairs"]}


def _pad_taps(xc: torch.Tensor, subdivisions: int):
    """``ico_pad`` the chart-split grid (float32, 'average' corners) -> (the
    centre, the 6 neighbour views). The 'average' corners put the pole mean
    in the two pole-adjacent halo cells, which is the pole vertex of
    ``grid_to_vertices``, so the pole tap of those cells reads the true
    neighbour."""
    from geniconet_tpu_torch.ops.pad import ico_pad

    h, w = xc.shape[2], xc.shape[3]
    P = ico_pad(xc.float(), subdivisions, "average")
    taps = [P[:, :, 1 + di : 1 + di + h, 1 + dj : 1 + dj + w, :] for di, dj in _HEX_OFFS]
    return P[:, :, 1 : 1 + h, 1 : 1 + w, :], taps


def vertex_normals_grid(xc: torch.Tensor, subdivisions: int):
    """Chart-split position grid (B, 5, h, w, 3) -> (grid normals
    (B, 5, h, w, 3), pole normals (B, 2, 3)), unit length: the values of
    ``vertex_normals``. Face (x, a, b) in outward orientation adds
    cross(a - x, b - x) to x."""
    t = _stencil_on(subdivisions, str(xc.device))
    x, taps = _pad_taps(xc, subdivisions)
    u = [tap - x for tap in taps]
    vn = None
    for (i, j), m in t["pair_masks"]:
        contrib = torch.linalg.cross(u[i], u[j], dim=-1) * m
        vn = contrib if vn is None else vn + contrib
    vn = vn / safe_norm(vn)
    # poles: 5 incident faces each, corners in oriented pairs
    cn, cs = xc[:, :, 0, 0, :].float(), xc[:, :, -1, -1, :].float()  # (B, 5, 3)
    un, us = cn - cn.mean(dim=1, keepdim=True), cs - cs.mean(dim=1, keepdim=True)
    npairs, spairs = t["pole_pairs"]
    nn_ = sum(torch.linalg.cross(un[:, i], un[:, j], dim=-1) for i, j in npairs)
    sn = sum(torch.linalg.cross(us[:, i], us[:, j], dim=-1) for i, j in spairs)
    poles = torch.stack([nn_, sn], dim=1)
    return vn, poles / safe_norm(poles)


def laplacian_grid(xc: torch.Tensor, subdivisions: int):
    """Chart-split signal (B, 5, h, w, C) -> (grid Laplacian (B, 5, h, w, C),
    pole Laplacian (B, 2, C)): ``laplacian``'s values. A pole's neighbours
    are the 5 chart corners and the pole is their mean, so its Laplacian
    is zero."""
    t = _stencil_on(subdivisions, str(xc.device))
    x, taps = _pad_taps(xc, subdivisions)
    acc = None
    for i in range(6):
        contrib = taps[i] * t["lap_mask"][i]
        acc = contrib if acc is None else acc + contrib
    poles = torch.zeros((xc.shape[0], 2, xc.shape[-1]), dtype=torch.float32, device=xc.device)
    return acc / t["deg"] - x, poles


# ---------------------------------------------------------------------------
# numpy twins (datasets)
# ---------------------------------------------------------------------------


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

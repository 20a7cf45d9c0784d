"""Point-to-mesh distance: the evaluation metric of record.

Port of ``geniconet_tpu/ops/point_mesh.py``. The reference averages the
squared point-to-mesh distances of kaolin 0.9.1's ``point_to_mesh_distance``
(reference ico_utils.py:26-44, run.py:531-534). Here every (point, triangle)
pair gets the exact closest point by Ericson's region classification, over
chunks of triangles with a running min, so the (P, F) pair matrix never
exists at once. It runs on the device of its inputs, in float32, with the
JAX package's region order and clamps; each pair's terms are formed one
coordinate at a time, so a chunk holds (P, chunk) tensors and no
(P, chunk, 3) ones.

``point_to_mesh_distance_numpy`` is the float64 oracle of the tests.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["point_to_triangle_sq", "point_to_mesh_distance", "point_to_mesh_distance_numpy"]

_EPS = 1e-20


def _dot(u, v):
    """sum_k u[k]·v[k] over three coordinates (tuples of broadcastable tensors)."""
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def point_to_triangle_sq(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """(P, 3) points, (T, 3, 3) triangles -> (P, T) squared distances."""
    p = tuple(p[:, None, k] for k in range(3))               # 3 x (P, 1)
    a, b, c = (tuple(tri[None, :, i, k] for k in range(3)) for i in range(3))  # 3 x (1, T)
    ab = tuple(bk - ak for ak, bk in zip(a, b))
    ac = tuple(ck - ak for ak, ck in zip(a, c))

    ap = tuple(pk - ak for pk, ak in zip(p, a))
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    del ap
    bp = tuple(pk - bk for pk, bk in zip(p, b))
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    del bp
    cp = tuple(pk - ck for pk, ck in zip(p, c))
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    del cp

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # face region barycentric coordinates, then the edge clamps
    denom = torch.clamp_min(va + vb + vc, _EPS)
    v_f, w_f = vb / denom, vc / denom
    t_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, _EPS), 0.0, 1.0)
    t_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, _EPS), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6), _EPS), 0.0, 1.0)

    # region selection (Ericson, Real-Time Collision Detection §5.1.5), in
    # the JAX package's order: each later region overrides the earlier ones,
    # so vertex a, applied last, wins
    regions = (
        (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),     # edge bc
        (vb <= 0) & (d2 >= 0) & (d6 <= 0),                   # edge ac
        (vc <= 0) & (d1 >= 0) & (d3 <= 0),                   # edge ab
        (d6 >= 0) & (d5 <= d6),                              # vertex c
        (d3 >= 0) & (d4 <= d3),                              # vertex b
        (d1 <= 0) & (d2 <= 0),                               # vertex a
    )
    del d1, d2, d3, d4, d5, d6, va, vb, vc, denom
    out = None
    for k in range(3):
        q = a[k] + v_f * ab[k] + w_f * ac[k]
        for mask, cand in zip(regions, (b[k] + t_bc * (c[k] - b[k]), a[k] + t_ac * ac[k],
                                        a[k] + t_ab * ab[k], c[k], b[k], a[k])):
            q = torch.where(mask, cand, q)
        dk = p[k] - q
        out = dk * dk if out is None else out + dk * dk
    return out


def point_to_mesh_distance(points: torch.Tensor, mesh_vertices: torch.Tensor, faces,
                           chunk: int = 2048, squared: bool = True) -> torch.Tensor:
    """(P,) min distance from each point to the triangle mesh (V, 3) with
    ``faces`` (F, 3), on ``points``' device: squared (kaolin 0.9.1's
    convention, the reference's metric) or Euclidean. ``chunk`` triangles
    a step bound the working set at a few dozen (P, chunk) float32 tensors."""
    dev = points.device
    faces = torch.as_tensor(faces, dtype=torch.long, device=dev)
    tri = mesh_vertices.to(dev, torch.float32)[faces]                 # (F, 3, 3)
    pad = (-tri.shape[0]) % chunk
    if pad:  # copies of the first triangle cannot lower the min
        tri = torch.cat([tri, tri[:1].expand(pad, 3, 3)])
    p = points.to(torch.float32)
    best = torch.full((p.shape[0],), torch.inf, dtype=torch.float32, device=dev)
    for tri_chunk in tri.split(chunk):
        best = torch.minimum(best, point_to_triangle_sq(p, tri_chunk).amin(dim=1))
    return best if squared else torch.sqrt(best)


def point_to_mesh_distance_numpy(points, mesh_vertices, faces, squared=True):
    """Exact numpy oracle (double precision, brute force)."""
    p = np.asarray(points, np.float64)
    tri = np.asarray(mesh_vertices, np.float64)[np.asarray(faces)]
    best = np.full(p.shape[0], np.inf)
    for k in range(tri.shape[0]):
        a, b, c = tri[k]
        ab, ac = b - a, c - a
        ap = p - a
        d1, d2 = ap @ ab, ap @ ac
        bp = p - b
        d3, d4 = bp @ ab, bp @ ac
        cp = p - c
        d5, d6 = cp @ ab, cp @ ac
        va = d3 * d6 - d5 * d4
        vb = d5 * d2 - d1 * d6
        vc = d1 * d4 - d3 * d2
        q = np.empty_like(p)
        # face region
        denom = np.maximum(va + vb + vc, 1e-300)
        v = (vb / denom)[:, None]
        w = (vc / denom)[:, None]
        q[:] = a + v * ab + w * ac
        m = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
        t = np.clip((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-300), 0, 1)
        q[m] = b + t[m, None] * (c - b)
        m = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
        t = np.clip(d2 / np.maximum(d2 - d6, 1e-300), 0, 1)
        q[m] = a + t[m, None] * ac
        m = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
        t = np.clip(d1 / np.maximum(d1 - d3, 1e-300), 0, 1)
        q[m] = a + t[m, None] * ab
        m = (d6 >= 0) & (d5 <= d6)
        q[m] = c
        m = (d3 >= 0) & (d4 <= d3)
        q[m] = b
        m = (d1 <= 0) & (d2 <= 0)
        q[m] = a
        d = ((p - q) ** 2).sum(1)
        best = np.minimum(best, d)
    return best if squared else np.sqrt(best)

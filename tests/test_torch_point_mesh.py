"""The port's point-to-mesh distance (``ops/point_mesh.py``) on the CPU,
against the JAX package's ``point_to_mesh_distance`` and the float64 oracle.

* Every region of one triangle, hand-checked, equal to JAX's
  ``point_to_triangle_sq``.
* Points on the mesh give 0; a point on an edge or a vertex too.
* The chunk (7, 64 and 2048 triangles a step, the last padded with copies
  of triangle 0) changes no bit.
* Random points against random icospheres, s=1-3: within rtol 1e-4 plus
  1e-6 x the mesh's extent squared of JAX's float32 result and of the
  float64 oracle (the two float32 versions differ by the order of their
  3-term sums only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.ops import point_mesh as jax_pm
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.point_mesh import (
    point_to_mesh_distance,
    point_to_mesh_distance_numpy,
    point_to_triangle_sq,
)

RTOL, ATOL = 1e-4, 1e-6  # ATOL times the mesh's extent squared


def _mesh(s, seed):
    """A bumpy icosphere (radii 0.8-1.2) and points around it."""
    rng = np.random.RandomState(seed)
    v = ico.get_vertex_coords(s) * rng.uniform(0.8, 1.2, (ico.num_vertices(s), 1))
    pts = rng.randn(97, 3) * 0.9
    return pts.astype(np.float32), v.astype(np.float32), ico.get_ico_faces(s)


def _close(got, want, v):
    extent = float(np.abs(v).max()) ** 2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * extent)


def test_point_to_triangle_regions():
    """Hand-checked distances in every Voronoi region of one triangle, the
    same as JAX's."""
    tri = np.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    pts = np.array([
        [0.25, 0.25, 1.0],   # above the face -> 1
        [-1.0, -1.0, 0.0],   # vertex a -> 2
        [2.0, 0.0, 0.0],     # vertex b -> 1
        [0.0, 2.0, 0.0],     # vertex c -> 1
        [0.5, -1.0, 0.0],    # edge ab -> 1
        [-1.0, 0.5, 0.0],    # edge ac -> 1
        [1.0, 1.0, 0.0],     # edge bc -> 0.5
        [0.2, 0.2, 0.0],     # inside -> 0
        [0.5, 0.0, 0.0],     # on edge ab -> 0
        [0.0, 0.0, 0.0],     # on vertex a -> 0
    ], np.float32)
    d = point_to_triangle_sq(torch.from_numpy(pts), torch.from_numpy(tri))[:, 0].numpy()
    np.testing.assert_allclose(d, [1.0, 2.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.0, 0.0, 0.0],
                               rtol=1e-5, atol=1e-6)
    ref = np.asarray(jax_pm.point_to_triangle_sq(jnp.asarray(pts), jnp.asarray(tri)))[:, 0]
    np.testing.assert_allclose(d, ref, rtol=1e-6, atol=1e-7)


def test_points_on_the_mesh_are_zero():
    s = 2
    v = ico.get_vertex_coords(s).astype(np.float32)
    f = ico.get_ico_faces(s)
    on_faces = v[f[:40]].mean(axis=1)  # centroids
    pts = torch.from_numpy(np.concatenate([v[:50], on_faces]))
    d = point_to_mesh_distance(pts, torch.from_numpy(v), f)
    assert d.shape == (90,) and d.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-10)


def test_the_chunk_changes_no_bit():
    pts, v, f = _mesh(2, seed=3)  # 320 faces: 7 pads the last chunk, 2048 pads 1728
    got = [point_to_mesh_distance(torch.from_numpy(pts), torch.from_numpy(v), f, chunk=c)
           for c in (7, 64, 2048)]
    for d in got[1:]:
        assert torch.equal(d, got[0])


@pytest.mark.parametrize("s", [1, 2, 3])
def test_matches_jax_and_the_float64_oracle(s):
    pts, v, f = _mesh(s, seed=s)
    got = point_to_mesh_distance(torch.from_numpy(pts), torch.from_numpy(v),
                                 torch.from_numpy(f), chunk=64).numpy()
    ref = np.asarray(jax_pm.point_to_mesh_distance(jnp.asarray(pts), jnp.asarray(v),
                                                   jnp.asarray(f), chunk=64))
    oracle = point_to_mesh_distance_numpy(pts, v, f)
    _close(got, ref, v)
    _close(got, oracle, v)
    root = point_to_mesh_distance(torch.from_numpy(pts), torch.from_numpy(v), f, squared=False)
    np.testing.assert_array_equal(root.numpy(), np.sqrt(got))

"""Host-side mesh kernels (C++ via ctypes).

* ``point_to_mesh_distance_native(points, verts, faces)``: exact squared
  point-to-mesh distances, computed in double precision; the oracle that
  ``ops/point_mesh.py`` is held against (kaolin 0.9.1's metric, reference
  ico_utils.py:26-44).
* ``detect_self_intersection(verts, faces)``: the intersecting,
  non-adjacent face pairs of a mesh, the explorer's "selfintersection"
  coloring (reference visualizer_utils.py:50-58, which used PyMesh).

The C++ source (``src/geniconet_native.cc``) is compiled with ``g++`` on
first use into ``build/native/`` at the repo root when the package is
imported from a checkout, or ``~/.cache/geniconet_tpu_torch/native`` when it
is installed, named by a hash of the source. Without a compiler, or if the
build fails, the call raises: there is no slower fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["build", "point_to_mesh_distance_native", "detect_self_intersection"]

SRC = Path(__file__).resolve().parent / "src" / "geniconet_native.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_LOCK = threading.Lock()


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists() and (root / "geniconet_tpu_torch").is_dir():
        return root / "build" / "native"  # a checkout of the repo
    return Path.home() / ".cache" / "geniconet_tpu_torch" / "native"  # an installed copy


def build() -> Path:
    """Compile the library if this source has none yet; return its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    out_dir = _build_dir()
    lib = out_dir / f"libgeniconet_native_{h}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ found: the native mesh library cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def _library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            lib.ptm_distance.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int, ip, ctypes.c_int, fp]
            lib.ptm_distance.restype = None
            lib.self_intersections.argtypes = [fp, ctypes.c_int, ip, ctypes.c_int, ip,
                                               ctypes.c_int]
            lib.self_intersections.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _mesh(verts, faces):
    """Contiguous float32 (V, 3) vertices and int32 (F, 3) faces that index them."""
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"want (V, 3) vertices and (F, 3) faces, got {v.shape}, {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError(f"face indices outside [0, {v.shape[0]})")
    return v, f


def point_to_mesh_distance_native(points, verts, faces) -> np.ndarray:
    """(P,) squared distances from each point to the mesh, float32 (the
    double-precision minimum rounded once)."""
    p = np.ascontiguousarray(points, np.float32)
    if p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"want (P, 3) points, got {p.shape}")
    v, f = _mesh(verts, faces)
    lib = _library()
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    out = np.empty(p.shape[0], np.float32)
    lib.ptm_distance(p.ctypes.data_as(fp), p.shape[0], v.ctypes.data_as(fp), v.shape[0],
                     f.ctypes.data_as(ip), f.shape[0], out.ctypes.data_as(fp))
    return out


def detect_self_intersection(verts, faces) -> np.ndarray:
    """(K, 2) int32 indices of intersecting, non-adjacent face pairs, sorted."""
    v, f = _mesh(verts, faces)
    lib = _library()
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)

    def run(cap):
        out = np.empty((cap, 2), np.int32)
        n = lib.self_intersections(v.ctypes.data_as(fp), v.shape[0], f.ctypes.data_as(ip),
                                   f.shape[0], out.ctypes.data_as(ip), cap)
        return n, out

    n, out = run(max(1024, f.shape[0]))
    if n > out.shape[0]:  # rerun with enough room
        n, out = run(n)
    return out[:n].copy()

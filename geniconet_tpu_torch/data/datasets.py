"""Datasets: npz and mat ico-signal loading, directory layouts, synthetic meshes.

Port of ``geniconet_tpu/data/datasets.py`` (which imports JAX through
``ops/mesh_math.py``). File contract: each sample is an ``.npz`` with key
``"data"`` of shape ``(9, V)`` — rows 0:3 positions, 3:6 normals, 6:9
Laplacian, poles last (V = 10·4^s + 2). The network input is rows 0:3
without the poles as a ``(5·2^s, 2^(s+1), 3)`` grid; the target is ``(V, 9)``.
The reference's own ``.mat`` grids (``"variable"``, ``(H, W, C)`` scaled by
255) load too, their normals and Laplacian computed from the positions.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.mesh_math import laplacian_numpy, vertex_normals_numpy
from geniconet_tpu_torch.ops.vertices import grid_to_vertices

__all__ = [
    "natural_sort", "list_files", "load_ico_npz", "load_ico_mat", "save_ico_npz", "IcoDataset",
    "synthetic_dataset", "synthetic_vertices",
]

_NUM_RE = re.compile(r"(\d+)")


def natural_sort(names):
    """Numeric-aware sort."""
    return sorted(names, key=lambda s: [int(t) if t.isdigit() else t.lower()
                                        for t in _NUM_RE.split(str(s))])


def list_files(root: str, ext: str = ".npz", level: int = 2, instance: str = "trn"):
    """Dataset files: ``level=1`` ``<root>/*<ext>``; ``level=2``
    ``<root>/<class>/{train,test}/*<ext>`` (trn -> train, val/tst -> test)."""
    out = []
    if level == 1:
        out = [os.path.join(root, f) for f in natural_sort(os.listdir(root)) if f.endswith(ext)]
    elif level == 2:
        sub = {"trn": "train", "val": "test", "tst": "test"}.get(instance, instance)
        for cls in sorted(os.listdir(root)):
            d = os.path.join(root, cls, sub)
            if os.path.isdir(d):
                out += [os.path.join(d, f) for f in natural_sort(os.listdir(d)) if f.endswith(ext)]
    else:
        raise ValueError(f"unsupported layout level {level}")
    return out


def load_ico_npz(path: str, subdivisions: int):
    """-> (input grid (H, W, 3) float32, target (V, 9) float32)."""
    data = np.load(path)["data"].astype(np.float32)
    V = ico.num_vertices(subdivisions)
    if data.shape != (9, V):
        raise ValueError(f"{path}: expected (9, {V}), got {data.shape}")
    H, W = ico.grid_shape(subdivisions)
    grid = data[0:3, :-2].reshape(3, H, W).transpose(1, 2, 0)
    return np.ascontiguousarray(grid), np.ascontiguousarray(data.T)


def load_ico_mat(path: str, subdivisions: int):
    """A reference ``.mat`` ico grid (reference data.py:47-58) -> the
    ``load_ico_npz`` pair. ``variable`` is (H, W, C) with 0-255-scaled
    positions in channels 0:3; the target's normals and Laplacian are
    computed from the loaded positions."""
    from scipy.io import loadmat

    md = loadmat(path)
    if "sparse_weights" in md:
        raise ValueError(f"{path}: sampling-weight .mat files are preprocessing inputs — "
                         "use geniconet_tpu_torch.data.generate")
    if "variable" not in md:
        raise ValueError(f"{path}: unhandleable .mat contents")
    arr = np.asarray(md["variable"], np.float32)
    H, W = ico.grid_shape(subdivisions)
    if arr.shape[:2] != (H, W):
        raise ValueError(f"{path}: expected ({H}, {W}, C), got {arr.shape}")
    grid = np.ascontiguousarray(arr[:, :, :3] / 255.0)
    if np.isnan(grid).any():
        raise ValueError(f"{path}: NaNs in the data")
    v = grid_to_vertices(torch.from_numpy(grid[None]), subdivisions)[0].numpy()
    faces = ico.get_ico_faces(subdivisions)
    target = np.concatenate([v, vertex_normals_numpy(v, faces), laplacian_numpy(v, faces)],
                            axis=1).astype(np.float32)
    return grid, np.ascontiguousarray(target)


def save_ico_npz(path: str, pos: np.ndarray, nor: np.ndarray, lap: np.ndarray):
    """Write the (9, V) ``"data"`` npz that ``load_ico_npz`` reads
    (reference generate.py:200-203)."""
    data = np.concatenate([pos, nor, lap], axis=1).astype(np.float32)
    np.savez(path, data=data.transpose())


@dataclass
class IcoDataset:
    """Packed in-memory dataset: inputs (N, H, W, 3), targets (N, V, 9)
    [pos | normals | laplacian], per-sample names and class labels."""

    inputs: np.ndarray
    targets: np.ndarray
    names: list[str] = field(default_factory=list)
    classes: list[str] = field(default_factory=list)
    subdivisions: int = 5

    def __len__(self):
        return self.inputs.shape[0]

    @staticmethod
    def from_directory(root: str, subdivisions: int, level: int = 2, instance: str = "trn",
                       ext: str = ".npz", quick_learn: int = 0) -> "IcoDataset":
        files = list_files(root, ext, level, instance)
        if quick_learn:
            files = files[:quick_learn]
        if not files:
            raise FileNotFoundError(f"no {ext} files under {root} ({instance})")
        H, W = ico.grid_shape(subdivisions)
        inputs = np.empty((len(files), H, W, 3), np.float32)
        targets = np.empty((len(files), ico.num_vertices(subdivisions), 9), np.float32)
        names, classes = [], []
        loader = load_ico_mat if ext == ".mat" else load_ico_npz
        for k, f in enumerate(files):
            inputs[k], targets[k] = loader(f, subdivisions)
            names.append(os.path.splitext(os.path.basename(f))[0])
            classes.append(os.path.basename(os.path.dirname(os.path.dirname(f)))
                           if level == 2 else "")
        return IcoDataset(inputs, targets, names, classes, subdivisions)


def synthetic_vertices(subdivisions: int, rng: np.random.RandomState, n_modes: int = 6):
    """One random smooth genus-0 mesh on the ico grid: r(x) = 1 + bumps."""
    base = ico.get_vertex_coords(subdivisions).astype(np.float32)
    r = np.ones(base.shape[0], np.float32)
    for _ in range(n_modes):
        d = rng.randn(3).astype(np.float32)
        d /= np.linalg.norm(d)
        freq = rng.uniform(1.0, 3.0)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.02, 0.12)
        r += amp * np.sin(freq * np.pi * (base @ d) + phase).astype(np.float32)
    scale = rng.uniform(0.5, 0.9)
    return (scale / np.abs(r).max()) * r[:, None] * base


def synthetic_dataset(subdivisions: int, n: int, seed: int = 0,
                      class_names: tuple[str, ...] = ("synth",)) -> IcoDataset:
    """Random smooth meshes scaled into (-1, 1) with consistent
    (pos, nor, lap) targets; the same samples as the JAX package's."""
    rng = np.random.RandomState(seed)
    faces = ico.get_ico_faces(subdivisions)
    H, W = ico.grid_shape(subdivisions)
    V = ico.num_vertices(subdivisions)
    inputs = np.empty((n, H, W, 3), np.float32)
    targets = np.empty((n, V, 9), np.float32)
    names, classes = [], []
    for k in range(n):
        v = synthetic_vertices(subdivisions, rng)
        targets[k] = np.concatenate(
            [v, vertex_normals_numpy(v, faces), laplacian_numpy(v, faces)], axis=1)
        inputs[k] = v[:-2].reshape(H, W, 3)
        names.append(f"synth_{k}")
        classes.append(class_names[k % len(class_names)])
    return IcoDataset(inputs, targets, names, classes, subdivisions)

"""Offline preprocessing CLI: manifold ``.off`` + sampling-weight ``.mat`` → ``.npz``.

Port of ``geniconet_tpu/data/generate.py``, in numpy and scipy.
Behavioral contract of reference ``generate.py``: for each (mesh, weights)
pair matched by the numeric id in ``<stem>_<id>`` filenames, build the sparse
resampling matrix ``(V_ico × N_orig)`` from 1-based ``.mat`` indices
(generate.py:52-60, 170-173), compute ``ico_signal = W · V`` (:176), reject
NaNs (:179-181), optionally normalize to the unit sphere (:184-191 — note
the reference's ``gt_samp_v`` branch references an unassigned variable; here
normalization uses the sampled vertices only, which is what the working code
path computes), then attach area-weighted vertex normals (:194) and the
umbrella Laplacian (:197) from this framework's geometry, and save the
``(9, V)`` ``data`` npz (:200-203).

Directory nesting (generate.py:99-117): ``--nested_dir 0`` flat,
``1`` one level (SHREC), ``2`` two levels (ModelNet ``class/{train,test}``).

Usage:
    python -m geniconet_tpu_torch.data.generate --data_dir D --samp_weights_dir W \
        --out_dir O [--normalization_mode unitsphere] [--nested_dir 2] \
        [--subdivision 5]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from geniconet_tpu_torch.data.datasets import save_ico_npz
from geniconet_tpu_torch.data.offio import read_off
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.mesh_math import laplacian_numpy, vertex_normals_numpy

NORMALIZATION_MODES = ["none", "unitsphere"]

__all__ = ["read_sparse_weights", "resample_to_ico", "process_pair", "main"]


def read_sparse_weights(mat_file: str):
    """1-based (N, 2) indices + weights from a .mat (generate.py:52-60)."""
    from scipy.io import loadmat

    md = loadmat(mat_file)
    idx = md["sparse_indices"].astype(np.int64) - 1
    w = md["sparse_weights"].astype(np.float32)
    return idx, w


def resample_to_ico(vertices: np.ndarray, sparse_indices, sparse_weights, n_ico: int):
    """ico_signal = W · V with W the (n_ico × N_orig) sampling matrix."""
    from scipy.sparse import coo_matrix

    W = coo_matrix(
        (
            sparse_weights.flatten(),
            (sparse_indices[:, 0].flatten(), sparse_indices[:, 1].flatten()),
        ),
        shape=(n_ico, vertices.shape[0]),
    )
    return W.dot(vertices).astype(np.float32)


def _normalize_unitsphere(points: np.ndarray):
    centroid = points.mean(axis=0)
    scale = np.sqrt(((points - centroid) ** 2).sum(axis=1)).max()
    return (points - centroid) / scale


def process_pair(off_path: str, mat_path: str, out_path: str, subdivisions: int,
                 normalization_mode: str = "none") -> bool:
    """One mesh: .off + .mat -> .npz. Returns False on NaN rejection."""
    ico_f = ico.get_ico_faces(subdivisions)
    data_v, _ = read_off(off_path)
    idx, w = read_sparse_weights(mat_path)
    samp = resample_to_ico(np.asarray(data_v, np.float32), idx, w, ico.num_vertices(subdivisions))
    if np.any(np.isnan(samp)):
        print(f"ERROR file {off_path}, NaNs in the data")
        return False
    if normalization_mode == "unitsphere":
        samp = _normalize_unitsphere(samp)
    nor = vertex_normals_numpy(samp, ico_f).astype(np.float32)
    lap = laplacian_numpy(samp, ico_f).astype(np.float32)
    save_ico_npz(out_path, samp, nor, lap)
    return True


def _numeric_id(path: str) -> int:
    stem = os.path.splitext(os.path.basename(path))[0]
    return int(stem.split("_")[1])


def _iter_dirs(data_dir: str, sw_dir: str, nested: int):
    if nested == 2:
        for f1 in sorted(os.listdir(data_dir)):
            for f2 in sorted(os.listdir(os.path.join(data_dir, f1))):
                yield os.path.join(data_dir, f1, f2), os.path.join(sw_dir, f1, f2)
    elif nested == 1:
        for f in sorted(os.listdir(data_dir)):
            yield os.path.join(data_dir, f), os.path.join(sw_dir, f)
    else:
        yield data_dir, sw_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--samp_weights_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--normalization_mode", choices=NORMALIZATION_MODES,
                   default="none")
    p.add_argument("--nested_dir", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--subdivision", type=int, default=5)
    a = p.parse_args(argv)

    for d in (a.data_dir, a.samp_weights_dir):
        if not os.path.exists(d):
            p.error(f"{d} does not exist")

    n_done = n_skip = 0
    for data_dir, sw_dir in _iter_dirs(a.data_dir, a.samp_weights_dir, a.nested_dir):
        offs = [f for f in os.listdir(data_dir) if f.endswith(".off")]
        mats = [f for f in os.listdir(sw_dir) if f.endswith(".mat")]
        if not offs or not mats:
            print(f"no files found in {data_dir} / {sw_dir}")
            continue
        id_off = {_numeric_id(f): f for f in offs}
        id_mat = {_numeric_id(f): f for f in mats}
        common = sorted(set(id_off) & set(id_mat))
        print(f"{data_dir}: {len(offs)} off, {len(mats)} mat, {len(common)} matched")

        if a.nested_dir == 2:
            out_dir = os.path.join(
                a.out_dir, os.path.basename(os.path.dirname(sw_dir)), os.path.basename(sw_dir)
            )
        elif a.nested_dir == 1:
            out_dir = os.path.join(a.out_dir, os.path.basename(sw_dir))
        else:
            out_dir = a.out_dir
        os.makedirs(out_dir, exist_ok=True)

        for i in common:
            out_path = os.path.join(out_dir, os.path.splitext(id_mat[i])[0] + ".npz")
            if os.path.exists(out_path):
                n_skip += 1
                continue
            ok = process_pair(
                os.path.join(data_dir, id_off[i]),
                os.path.join(sw_dir, id_mat[i]),
                out_path,
                a.subdivision,
                a.normalization_mode,
            )
            n_done += int(ok)
    print(f"done: {n_done} written, {n_skip} skipped (already exist)")


if __name__ == "__main__":
    main()

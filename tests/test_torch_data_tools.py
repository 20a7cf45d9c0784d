"""The port's data tools against the JAX package's, on the CPU.

* ``load_ico_mat`` (a ``savemat`` fixture of the reference's (H, W, C)
  0-255 grid) and ``IcoDataset.from_directory(ext=".mat")`` at layout
  levels 1 and 2 give what JAX's give, to the bit; a sampling-weight
  ``.mat`` is refused in both.
* ``read_ply`` reads ascii and binary_little_endian files as JAX's does.
* ``generate.process_pair`` and ``generate.main`` write the same ``.npz``
  as JAX's (positions, normals, Laplacian to the bit), with and without
  the unit-sphere normalisation; ``save_ico_npz`` round-trips through
  ``load_ico_npz``.
"""

import os
import struct

import numpy as np
import pytest
from scipy.io import savemat

from geniconet_tpu.data import datasets as jax_datasets
from geniconet_tpu.data import generate as jax_generate
from geniconet_tpu.data import offio as jax_offio
from geniconet_tpu_torch.data import datasets, generate, offio
from geniconet_tpu_torch.geometry import ico

S = 2


def _mat(path, seed):
    H, W = ico.grid_shape(S)
    arr = np.random.RandomState(seed).rand(H, W, 6) * 255
    savemat(path, {"variable": arr})
    return arr


def test_mat_grid_loads_as_in_jax(tmp_path):
    p = str(tmp_path / "sample_1.mat")
    arr = _mat(p, 0)
    grid, target = datasets.load_ico_mat(p, S)
    ref_grid, ref_target = jax_datasets.load_ico_mat(p, S)
    np.testing.assert_array_equal(grid, ref_grid)
    np.testing.assert_array_equal(target, ref_target)
    np.testing.assert_allclose(grid, arr[:, :, :3] / 255.0, rtol=1e-6)
    assert target.shape == (ico.num_vertices(S), 9) and target.dtype == np.float32
    savemat(str(tmp_path / "w_1.mat"), {"sparse_weights": np.ones((3, 1))})
    for load in (datasets.load_ico_mat, jax_datasets.load_ico_mat):
        with pytest.raises(ValueError, match="generate"):
            load(str(tmp_path / "w_1.mat"), S)


@pytest.mark.parametrize("level", [1, 2])
def test_mat_directory_loads_as_in_jax(tmp_path, level):
    d = tmp_path if level == 1 else tmp_path / "chair" / "test"
    d.mkdir(parents=True, exist_ok=True)
    for k in (10, 2, 1):
        _mat(str(d / f"m_{k}.mat"), k)
    got = datasets.IcoDataset.from_directory(str(tmp_path), S, level, "val", ".mat")
    ref = jax_datasets.IcoDataset.from_directory(str(tmp_path), S, level, "val", ".mat")
    assert got.names == ref.names == ["m_1", "m_2", "m_10"]
    assert got.classes == ref.classes
    np.testing.assert_array_equal(got.inputs, ref.inputs)
    np.testing.assert_array_equal(got.targets, ref.targets)


def _ply_files(tmp_path):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.5]], np.float32)
    f = np.array([[0, 1, 2], [0, 1, 3]], np.int64)
    ascii_p = tmp_path / "mesh_ascii.ply"
    with open(ascii_p, "w") as fh:
        fh.write("ply\nformat ascii 1.0\ncomment made by a test\n")
        fh.write(f"element vertex {len(v)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\nproperty uchar red\n")
        fh.write(f"element face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n")
        for row in v:
            fh.write(" ".join(str(float(x)) for x in row) + " 7\n")
        for row in f:
            fh.write("3 " + " ".join(str(int(x)) for x in row) + "\n")
    bin_p = tmp_path / "mesh_bin.ply"
    with open(bin_p, "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\n")
        fh.write(f"element vertex {len(v)}\n".encode())
        fh.write(b"property float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(f)}\n".encode())
        fh.write(b"property list uchar int vertex_indices\nend_header\n")
        for row in v:
            fh.write(struct.pack("<3f", *row))
        for row in f:
            fh.write(struct.pack("<B3i", 3, *row))
    return v, f, (ascii_p, bin_p)


def test_read_ply_as_in_jax(tmp_path):
    v, f, paths = _ply_files(tmp_path)
    for p in paths:
        got, ref = offio.read_ply(str(p)), jax_offio.read_ply(str(p))
        for a, b in zip(got, ref, strict=True):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(got[0], v)
        np.testing.assert_array_equal(got[1], f)


def _pair(tmp_path, idx, scale=0.7, seed=0):
    """A denser icosphere as the source mesh and a .mat whose 1-based
    sampling matrix averages the 3 source vertices nearest each ico vertex."""
    src_v = (ico.get_vertex_coords(S + 1) * scale).astype(np.float32)
    src_v += 0.01 * np.random.RandomState(seed).randn(*src_v.shape).astype(np.float32)
    off = str(tmp_path / f"mesh_{idx}.off")
    offio.write_off(off, src_v, ico.get_ico_faces(S + 1))
    tgt = ico.get_vertex_coords(S)
    rows, cols, vals = [], [], []
    for i in range(tgt.shape[0]):
        for j in np.argsort(np.linalg.norm(src_v / scale - tgt[i], axis=1))[:3]:
            rows.append(i + 1)
            cols.append(j + 1)
            vals.append(1.0 / 3.0)
    mat = str(tmp_path / f"weights_{idx}.mat")
    savemat(mat, {"sparse_indices": np.stack([rows, cols], axis=1).astype(np.float64),
                  "sparse_weights": np.asarray(vals, np.float32)[:, None]})
    return off, mat


@pytest.mark.parametrize("mode", ["none", "unitsphere"])
def test_process_pair_writes_jax_npz(tmp_path, mode):
    off, mat = _pair(tmp_path, 1)
    out, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert generate.process_pair(off, mat, out, S, mode)
    assert jax_generate.process_pair(off, mat, ref, S, mode)
    with np.load(out) as a, np.load(ref) as b:
        assert list(a) == list(b) == ["data"]
        assert a["data"].dtype == b["data"].dtype == np.float32
        np.testing.assert_array_equal(a["data"], b["data"])
    grid, target = datasets.load_ico_npz(out, S)
    assert target.shape == (ico.num_vertices(S), 9)
    datasets.save_ico_npz(str(tmp_path / "again.npz"), target[:, :3], target[:, 3:6],
                          target[:, 6:])
    np.testing.assert_array_equal(datasets.load_ico_npz(str(tmp_path / "again.npz"), S)[1],
                                  target)


def test_generate_cli_flat_as_in_jax(tmp_path, capsys):
    d_off, d_mat = tmp_path / "off", tmp_path / "mat"
    d_off.mkdir()
    d_mat.mkdir()
    for i in (1, 2):
        off, mat = _pair(tmp_path, i, seed=i)
        os.rename(off, d_off / os.path.basename(off))
        os.rename(mat, d_mat / os.path.basename(mat))
    offio.write_off(str(d_off / "mesh_99.off"), ico.get_vertex_coords(1), ico.get_ico_faces(1))
    for main, out in ((generate.main, "port"), (jax_generate.main, "jax")):
        main(["--data_dir", str(d_off), "--samp_weights_dir", str(d_mat),
              "--out_dir", str(tmp_path / out), "--subdivision", str(S)])
    assert "done: 2 written, 0 skipped" in capsys.readouterr().out
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == ["weights_1.npz", "weights_2.npz"]
    for name in files:
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "jax" / name) as b:
            np.testing.assert_array_equal(a["data"], b["data"])
    generate.main(["--data_dir", str(d_off), "--samp_weights_dir", str(d_mat),
                   "--out_dir", str(tmp_path / "port"), "--subdivision", str(S)])
    assert "done: 0 written, 2 skipped" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        generate.main(["--data_dir", str(tmp_path / "absent"), "--samp_weights_dir",
                       str(d_mat), "--out_dir", str(tmp_path / "x")])

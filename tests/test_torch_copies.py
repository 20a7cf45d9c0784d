"""The port's own copies of what it used from the JAX package, held equal to
the originals, and the entry points' device default.

* ``geniconet_tpu_torch/geometry/ico.py``: faces, vertex coordinates, patch
  ids, the neighbour and incident-face tables and shapes equal
  ``geniconet_tpu/geometry/ico.py``'s, s=0..5.
* ``geniconet_tpu_torch/train/config.py``: every field the port keeps has
  the JAX ``Config``'s default (``device`` is the port's own), and
  ``parse_args`` turns the JAX command lines into the same values.
* ``geniconet_tpu_torch/native``: the same self-intersecting face pairs as
  ``geniconet_tpu/native`` on one mesh with a dent pushed through it, and
  the same point-to-mesh distances (``ptm_distance``) to the bit.
* ``geniconet_tpu_torch/app/static``: the explorer's page and scripts equal
  ``geniconet_tpu/app/static``'s byte for byte.
* ``Trainer``, ``AppState``, ``Batches``, the command line and the
  explorer's server run on the card unless told otherwise: without one
  they raise instead of returning a CPU object.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from geniconet_tpu import native as jax_native
from geniconet_tpu.geometry import ico as jax_ico
from geniconet_tpu.train.config import Config as JaxConfig
from geniconet_tpu.train.config import parse_args as jax_parse_args
from geniconet_tpu_torch import Config, native
from geniconet_tpu_torch.train.config import parse_args
from geniconet_tpu_torch.geometry import ico


@pytest.mark.parametrize("s", [0, 1, 2, 3, 4, 5])
def test_ico_tables_equal_the_jax_module(s):
    for name in ("get_ico_faces", "get_vertex_coords", "get_patch_ids", "chart_shape",
                 "grid_shape", "num_vertices", "num_faces"):
        got, ref = getattr(ico, name)(s), getattr(jax_ico, name)(s)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=name)
    for name in ("get_neighbor_table", "get_vertex_face_table"):
        for got, ref in zip(getattr(ico, name)(s), getattr(jax_ico, name)(s), strict=True):
            np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_array_equal(ico.base_icosahedron()[0], jax_ico.base_icosahedron()[0])


@pytest.mark.parametrize("name", ["index.html", "app.js", "viewer.js"])
def test_explorer_static_files_equal_the_jax_package(name):
    from geniconet_tpu.app import server as jax_server
    from geniconet_tpu_torch.app import server

    jax_static = os.path.join(os.path.dirname(jax_server.__file__), "static")
    assert sorted(os.listdir(server.STATIC)) == sorted(os.listdir(jax_static))
    with open(os.path.join(server.STATIC, name), "rb") as f, \
            open(os.path.join(jax_static, name), "rb") as g:
        assert f.read() == g.read()


PORT_ONLY = {"cfg.device"}


def _defaults(obj, ref, path="cfg"):
    for f in dataclasses.fields(obj):
        if f"{path}.{f.name}" in PORT_ONLY:
            assert not hasattr(ref, f.name), f"{path}.{f.name}"
            continue
        got, want = getattr(obj, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _defaults(got, want, f"{path}.{f.name}")
        else:
            assert got == want, (f"{path}.{f.name}", got, want)


def test_config_defaults_equal_the_jax_config():
    cfg, ref = Config(), JaxConfig()
    _defaults(cfg, ref)
    assert cfg.model.is_vae == ref.model.is_vae is False
    cfg.model.name = "ico2ico_vae"
    assert cfg.model.is_vae


@pytest.mark.parametrize("argv", [
    "--model ico2ico --process train",
    "--model ico2ico_vae --process train --synthetic 64 --batch_size 36 --train_epoch 3 "
    "--compute_dtype bfloat16 --load_epoch 2 --seed 4 --widths 8 16 16 --subdivision 3",
    "--model ico2ico --process encode --logDir L --dataDir D --dataPthLvl 1 --quickLearn 5 "
    "--data_instance trn --outDir O --test_epoch B3 --corner_mode zeros --lr_max 0.01 "
    "--step_size_up 10 --f_pos 0.5 --f_kl 2 --log_encoding_epoch 3 --log_encoding_images "
    "--debug --profile_dir P --debug_nans --load_pretrained_model",
    "--model ico2ico_vae --process sample --n_samples 3 --latent_features 16 --encDir E "
    "--test_mode none --write_output_mesh --use_pallas --no_data_parallel --deviceResident on "
    "--backend_retries 0 --load_pt ref.pt",
])
def test_command_line_parses_as_the_jax_one(argv):
    cfg, ref = parse_args(argv.split()), jax_parse_args(argv.split())
    _defaults(cfg, ref)
    assert cfg.device == "cuda"
    assert parse_args([*argv.split(), "--device", "cpu"]).device == "cpu"


def test_self_intersection_matches_the_jax_native():
    s = 2
    verts = ico.get_vertex_coords(s).astype(np.float32)
    faces = ico.get_ico_faces(s)
    verts[5] *= -1.5  # one vertex pushed out through the far side: its fan crosses faces
    got = native.detect_self_intersection(verts, faces)
    ref = jax_native.detect_self_intersection(verts, faces)
    assert len(got) > 0
    np.testing.assert_array_equal(got, ref)
    assert native.build().parent.name == "native"  # built under build/, not in the package
    assert len(native.detect_self_intersection(ico.get_vertex_coords(s), faces)) == 0


def test_point_to_mesh_distance_matches_the_jax_native():
    s = 2
    rng = np.random.RandomState(4)
    verts = (ico.get_vertex_coords(s) * rng.uniform(0.8, 1.2, (ico.num_vertices(s), 1)))
    faces = ico.get_ico_faces(s)
    pts = np.concatenate([rng.randn(200, 3), verts[:20]]).astype(np.float32)
    got = native.point_to_mesh_distance_native(pts, verts, faces)
    assert got.shape == (220,) and got.dtype == np.float32 and not got[200:].any()
    np.testing.assert_array_equal(got, jax_native.point_to_mesh_distance_native(pts, verts,
                                                                               faces))
    with pytest.raises(ValueError, match="outside"):
        native.point_to_mesh_distance_native(pts, verts[:10], faces)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_default_to_the_card(no_card, tmp_path, monkeypatch):
    from geniconet_tpu_torch import cli
    from geniconet_tpu_torch.app import server
    from geniconet_tpu_torch.app.state import AppState
    from geniconet_tpu_torch.data.datasets import synthetic_dataset
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.train.trainer import Trainer

    cfg, vae = Config(), Config()
    cfg.model.subdivisions, cfg.model.widths = 3, (8, 8, 8)
    vae.model.name, vae.model.subdivisions, vae.model.widths = "ico2ico_vae", 3, (8, 8, 8)
    vae.model.latent_features = 8
    ds = synthetic_dataset(1, 2, seed=0)
    for make in (lambda: Trainer(cfg), lambda: Trainer(vae), AppState, lambda: Batches(ds, 2)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert Trainer(cfg, device="cpu").model.encoder.conv_in.taps.device.type == "cpu"
    assert Trainer(vae, device="cpu").model.mu_conv.taps.device.type == "cpu"
    assert AppState(device="cpu").device.type == "cpu"
    assert Batches(ds, 2, device="cpu").inputs.device.type == "cpu"
    # the explorer's server: its state on the card unless --device cpu
    with pytest.raises(RuntimeError, match="is_available"):
        server.build(["--no_autoload", "--port", "0"])
    srv = server.build(["--no_autoload", "--port", "0", "--device", "cpu"])
    assert srv.state.device.type == "cpu"
    srv.server_close()
    # the command line: every process on the card unless --device cpu
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = ["--model", "ico2ico", "--synthetic", "2", "--subdivision", "3", "--widths", "8", "8",
            "8", "--batch_size", "2", "--train_epoch", "1", "--logDir", str(tmp_path)]
    for process in ("train", "encode"):
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main([*argv, "--process", process])
    assert cli.main([*argv, "--process", "train", "--device", "cpu"])
    cli.main([*argv, "--process", "encode", "--device", "cpu"])
    for process in ("test", "decode"):  # past their checkpoints and encodings
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main([*argv, "--process", process])

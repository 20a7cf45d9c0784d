"""The port's own copies of what it used from the JAX package, held equal to
the originals, and the entry points' device default.

* ``geniconet_tpu_torch/geometry/ico.py``: faces, vertex coordinates, patch
  ids, the neighbour and incident-face tables and shapes equal
  ``geniconet_tpu/geometry/ico.py``'s, s=0..5.
* ``geniconet_tpu_torch/train/config.py``: every field the port keeps has
  the JAX ``Config``'s default.
* ``geniconet_tpu_torch/native``: the same self-intersecting face pairs as
  ``geniconet_tpu/native`` on one mesh with a dent pushed through it.
* ``Trainer``, ``AppState`` and ``Batches`` run on the card unless told
  otherwise: without one they raise instead of returning a CPU object.
"""

import dataclasses

import numpy as np
import pytest
import torch

from geniconet_tpu import native as jax_native
from geniconet_tpu.geometry import ico as jax_ico
from geniconet_tpu.train.config import Config as JaxConfig
from geniconet_tpu_torch import Config, native
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


def _defaults(obj, ref, path="cfg"):
    for f in dataclasses.fields(obj):
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


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_default_to_the_card(no_card):
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

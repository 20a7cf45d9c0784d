"""The port's AppState / handle_api decode routes against flax decode.

Every route's vertices are checked against ``model.apply(method="decode")``
+ ``grid_to_vertices`` of the flax IcoAE on the same latents (float32,
tolerance 1e-4·max|ref|), and the latent cache against flax encode.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from geniconet_tpu.data.datasets import synthetic_dataset as jax_synthetic_dataset
from geniconet_tpu.geometry import ico
from geniconet_tpu.nn.models import IcoAE as FlaxIcoAE
from geniconet_tpu.ops.vertices import grid_to_vertices
from geniconet_tpu.train.config import Config
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.app.server import handle_api
from geniconet_tpu_torch.app.state import AppState

S, WIDTHS, N = 3, (8, 12, 16), 6


@pytest.fixture(scope="module")
def served():
    cfg = Config()
    cfg.model.subdivisions, cfg.model.widths = S, WIDTHS
    cfg.data.synthetic = N
    variables = bridge.init_variables(S, WIDTHS, seed=3, random_stats=True)
    st = AppState(device="cpu")
    st.load(cfg, variables=variables)
    fm = FlaxIcoAE(subdivisions=S, widths=WIDTHS)

    def decode(zs):
        out = fm.apply(variables, jnp.asarray(np.asarray(zs, np.float32)), method="decode")
        return np.asarray(grid_to_vertices(out, S))

    def encode(xs):
        return np.asarray(fm.apply(variables, jnp.asarray(xs), method="encode"))

    return st, encode, decode


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _verts(payload):
    return np.asarray(payload["vertices"], np.float32).reshape(-1, 3)


def test_dataset_and_latent_cache(served):
    st, encode, _ = served
    ref = jax_synthetic_dataset(S, N, seed=0)
    np.testing.assert_array_equal(st.dataset.inputs, ref.inputs)
    np.testing.assert_allclose(st.dataset.targets, ref.targets, rtol=1e-6, atol=1e-6)
    assert st.latents.dtype == np.float32
    _close(st.latents, encode(st.dataset.inputs))
    info = handle_api(st, "/api/info", {})
    assert info["n"] == N and info["latent_shape"] == list(st.latents.shape[1:])


def test_decode_routes_match_flax(served):
    st, _, decode = served
    z = st.latents
    V = ico.num_vertices(S)
    mesh = _verts(handle_api(st, "/api/mesh", {"i": 1, "coloring": "patch"}))
    assert mesh.shape == (V, 3)
    _close(mesh, decode(z[1:2])[0])
    ref = _verts(handle_api(st, "/api/mesh", {"i": 1, "which": "reference",
                                              "coloring": "distance"}))
    _close(ref, st.dataset.targets[1, :, :3])
    interp = _verts(handle_api(st, "/api/interpolate", {"i": 0, "j": 2, "t": 0.25,
                                                        "coloring": "patch"}))
    _close(interp, decode((0.75 * z[0] + 0.25 * z[2])[None])[0])
    arith = _verts(handle_api(st, "/api/arithmetic", {
        "terms": [{"op": "+", "i": 0}, {"op": "-", "i": 1}, {"op": "+", "i": 2}],
        "coloring": "none"}))
    _close(arith, decode((z[0] - z[1] + z[2])[None])[0])
    explore = _verts(handle_api(st, "/api/explore", {"i": 0, "channel": 2, "delta": 1.5,
                                                     "coloring": "patch"}))
    ze = z[0].copy()
    ze[..., 2] += 1.5 * z.std(axis=0)[..., 2].mean()
    _close(explore, decode(ze[None])[0])
    patch = _verts(handle_api(st, "/api/patch_combine", {"i": 0, "j": 1, "patches": [0, 3]}))
    zp, hz = z[0].copy(), 2 ** (S - 3)
    for c in (0, 3):
        zp[c * hz : (c + 1) * hz] = z[1][c * hz : (c + 1) * hz]
    _close(patch, decode(zp[None])[0])
    out = handle_api(st, "/api/decode", {"indices": [0, 2, 4]})
    _close(np.asarray(out["vertices"]), decode(z[[0, 2, 4]]), 1e-4)
    assert len(out["faces"]) == 3 * ico.num_faces(S)


def test_colorings_and_unported_routes(served, tmp_path):
    st, _, _ = served
    v = st.reconstruct(0)
    for mode in ["selfintersection", "distance", "patch", "none"]:
        c = st.colorize(v, mode, st.reference_vertices(0))
        assert c.shape == (v.shape[0], 3) and c.min() >= 0 and c.max() <= 1
    with pytest.raises(ValueError):
        handle_api(st, "/api/nope", {})
    # no variables: the checkpoint under the log directory, and there is none
    cfg = copy.deepcopy(st.cfg)
    cfg.log_dir = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="available"):
        AppState(device="cpu").load(cfg)
    with pytest.raises(FileNotFoundError, match="available"):
        handle_api(AppState(device="cpu"), "/api/load", {"logDir": str(tmp_path), "subdivision": S,
                                                         "synthetic": N})

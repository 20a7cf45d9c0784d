"""The port's explorer (``app/server.py``, ``app/state.py``) against the JAX
package's, on the CPU, with one checkpoint that both load.

The port's CLI trains an AE for one epoch (s=3, widths 8/12/16, 8 synthetic
meshes); the port's ``AppState`` (``device="cpu"``) and the JAX package's
load it through their ``/api/load``. Then:

* ``/api/pca``: the port's PCA points (``torch.linalg.svd``, scikit-learn's
  sign convention) within 1e-4·max|points| of the JAX state's
  scikit-learn points, the same names and classes; the fit cached as
  ``.pca.npz`` beside the JAX package's ``.pkl``, and read back by a fresh
  state bit for bit;
* ``/api/pairs`` (closest and farthest), ``/api/pca_decode`` and the
  ``nearest`` field of ``/api/arithmetic``: the same indices and names, the
  distances and vertices within 1e-4 of max|ref| (the JAX decode in
  float32: ``GENICONET_DECODE_QUANT=0``);
* ``/api/viewpoint``: a ``viewpoints.json`` that one package writes and the
  other reads, saves and deletes in;
* ``/api/export``: the JAX file names (``<name>_recon.off``,
  ``<name>_recon.fig.json``, ``_1`` for the second), never over a file;
  ``/api/view_file`` of the exported ``.off``, a ``.ply`` and an ``.npz``
  equal to the JAX package's answer, and a path outside the roots refused;
* over real HTTP (``make_server`` on port 0): the static page byte-equal
  to the JAX package's, a gzip body, and a refused path as a 500 with
  ``{"error": ...}``; ``build`` applies the command line.
"""

import gzip
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geniconet_tpu.app import server as jax_server
from geniconet_tpu.app.state import AppState as JaxAppState
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu.train.trainer import TrainState as JaxTrainState
from geniconet_tpu_torch import bridge, cli
from geniconet_tpu_torch.app import server
from geniconet_tpu_torch.app.state import AppState
from geniconet_tpu_torch.data.datasets import save_ico_npz, synthetic_dataset
from geniconet_tpu_torch.geometry import ico

S, WIDTHS, N = 3, (8, 12, 16), 8


def _template_state(self, sample_input, seed=0):
    """The JAX ``init_state``'s TrainState from seeded variables, without
    the flax init's compile: ``restore`` then replaces every leaf."""
    fresh = jax.tree.map(jnp.asarray, bridge.init_variables(S, WIDTHS, seed=seed))
    return JaxTrainState(params=fresh["params"], batch_stats=fresh["batch_stats"],
                         opt_state=self.tx.init(fresh["params"]), step=jnp.zeros((), jnp.int32),
                         rng=jax.random.key(seed + 2))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(port state, JAX api, load body): both states loaded from one checkpoint."""
    log_dir = tmp_path_factory.mktemp("explorer")
    body = {"model": "ico2ico", "logDir": str(log_dir), "synthetic": N, "subdivision": S,
            "widths": list(WIDTHS)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL only: fast
        cli.main(["--model", "ico2ico", "--subdivision", str(S), "--batch_size", "4",
                  "--synthetic", str(N), "--logDir", str(log_dir), "--widths",
                  *map(str, WIDTHS), "--device", "cpu", "--process", "train",
                  "--train_epoch", "1"])
        mp.setattr(JaxTrainer, "init_state", _template_state)
        mp.setenv("GENICONET_DECODE_QUANT", "0")  # float32 vertices, not the TPU's int16
        mp.setattr(jax_server, "STATE", JaxAppState())
        mp.setattr(jax_server, "ALLOWED_ROOTS", [])
        jax_server.handle_api("/api/load", body)
        st = AppState(device="cpu")
        info = server.handle_api(st, "/api/load", body)
        assert info["n"] == N and info["epoch"] == jax_server.STATE.epoch
        yield st, jax_server.handle_api, body


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _mesh_equal(got, ref):
    assert got["faces"] == ref["faces"]
    _close(got["vertices"], ref["vertices"])


def test_pca_matches_scikit_learn_and_is_cached(served):
    st, jax_api, _ = served
    got, ref = server.handle_api(st, "/api/pca", {}), jax_api("/api/pca", {})
    assert got["names"] == ref["names"] and got["classes"] == ref["classes"]
    _close(got["points"], ref["points"])
    assert np.asarray(got["points"]).shape == (N, 3)
    files = os.listdir(st.cfg.model_log_dir())
    npz = [f for f in files if f.endswith(".pca.npz")]
    pkl = [f for f in files if f.endswith(".pkl")]
    assert len(npz) == 1 and len(pkl) == 1 and npz[0][: -len(".pca.npz")] == pkl[0][:-4]
    fresh = AppState(device="cpu")
    fresh.cfg, fresh.dataset, fresh.epoch, fresh.instance = st.cfg, st.dataset, st.epoch, "val"
    fresh.latents = np.zeros((N, 1), np.float32)  # read from the file, not refit: only N counts
    fresh.fit_pca(fresh._pca_cache_path())
    np.testing.assert_array_equal(fresh.pca_points, st.pca_points)


def test_nearest_routes_and_pairs_match_jax(served):
    st, jax_api, _ = served
    for farthest in (False, True):
        body = {"k": 6, "farthest": farthest}
        got, ref = server.handle_api(st, "/api/pairs", body), jax_api("/api/pairs", body)
        assert [(p["i"], p["j"]) for p in got["pairs"]] == [(p["i"], p["j"]) for p in
                                                            ref["pairs"]]
        _close([p["d"] for p in got["pairs"]], [p["d"] for p in ref["pairs"]])
    points = np.asarray(jax_api("/api/pca", {})["points"])
    for i in (0, 3, 6):
        body = {"p": (points[i] + 0.01 * (points[(i + 1) % N] - points[i])).tolist(),
                "coloring": "patch"}
        got, ref = server.handle_api(st, "/api/pca_decode", body), jax_api("/api/pca_decode",
                                                                           body)
        assert (got["index"], got["name"]) == (ref["index"], ref["name"]) == (i, f"synth_{i}")
        _mesh_equal(got, ref)
    for terms in ([("+", 1), ("-", 2), ("+", 4)], [("+", 5)], [("+", 0), ("+", 7)]):
        body = {"terms": [{"op": o, "i": i} for o, i in terms], "coloring": "none"}
        got, ref = server.handle_api(st, "/api/arithmetic", body), jax_api("/api/arithmetic",
                                                                           body)
        assert got["nearest"] == ref["nearest"]
        _mesh_equal(got, ref)


def test_viewpoints_pass_between_the_packages(served):
    st, jax_api, _ = served
    cam = {"eye": [1.0, 2.0, 3.0], "up": [0, 0, 1]}
    server.handle_api(st, "/api/viewpoint", {"op": "save", "name": "port", "camera": cam})
    assert jax_api("/api/viewpoint", {})["viewpoints"] == {"port": cam}
    jax_api("/api/viewpoint", {"op": "save", "name": "jax", "camera": [4, 5]})
    assert server.handle_api(st, "/api/viewpoint", {"op": "list"})["viewpoints"] == {
        "port": cam, "jax": [4, 5]}
    server.handle_api(st, "/api/viewpoint", {"op": "delete", "name": "port"})
    assert jax_api("/api/viewpoint", {"op": "list"}) == {"viewpoints": {"jax": [4, 5]}}
    with open(os.path.join(st.cfg.model_log_dir(), "viewpoints.json")) as f:
        assert json.load(f) == {"jax": [4, 5]}


def test_export_and_view_file_match_jax(served, tmp_path):
    st, jax_api, _ = served
    out, jout = (os.path.join(st.cfg.log_dir, d) for d in ("port_export", "jax_export"))
    paths = [server.handle_api(st, "/api/export", {"i": 1, "dir": out})["path"]
             for _ in range(2)]
    paths.append(server.handle_api(st, "/api/export", {"i": 1, "dir": out, "fmt": "fig",
                                                       "coloring": "patch"})["path"])
    ref = [jax_api("/api/export", {"i": 1, "dir": jout})["path"] for _ in range(2)]
    ref.append(jax_api("/api/export", {"i": 1, "dir": jout, "fmt": "fig",
                                       "coloring": "patch"})["path"])
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in ref] == [
        "synth_1_recon.off", "synth_1_recon_1.off", "synth_1_recon.fig.json"]
    with open(paths[2]) as f, open(ref[2]) as g:
        fig, jfig = json.load(f), json.load(g)
    assert fig.keys() == jfig.keys() and fig["name"] == "synth_1" and fig["coloring"] == "patch"
    _mesh_equal(fig, jfig)
    assert fig["colors"] == jfig["colors"]
    # a .ply and an .npz under the log root
    ply = os.path.join(st.cfg.log_dir, "ico1.ply")
    verts, faces = ico.get_vertex_coords(1), ico.get_ico_faces(1)
    with open(ply, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(verts)}\nproperty float x\n"
                f"property float y\nproperty float z\nelement face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        f.writelines(" ".join(f"{c:.6f}" for c in v) + "\n" for v in verts)
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces)
    sample = synthetic_dataset(S, 3, seed=4).targets[2]
    npz = os.path.join(st.cfg.log_dir, "sample.npz")
    save_ico_npz(npz, sample[:, :3], sample[:, 3:6], sample[:, 6:9])
    for path in (paths[0], ref[0], ply, npz):
        got = server.handle_api(st, "/api/view_file", {"path": path})
        want = jax_api("/api/view_file", {"path": path})
        assert got == want
    v = np.asarray(server.handle_api(st, "/api/view_file", {"path": paths[0]})["vertices"])
    _close(v.reshape(-1, 3), st.reconstruct(1))
    outside = tmp_path / "outside.off"
    outside.write_text("OFF\n0 0 0\n")
    for api in (lambda p, b: server.handle_api(st, p, b), jax_api):
        with pytest.raises(PermissionError, match="outside"):
            api("/api/view_file", {"path": str(outside)})
        with pytest.raises(PermissionError, match="outside"):
            api("/api/export", {"i": 0, "dir": str(tmp_path)})


def _request(url, body=None, gzip_ok=False):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Accept-Encoding": "gzip"} if gzip_ok else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_server(served, tmp_path):
    st, jax_api, _ = served
    srv = server.make_server(st, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        static = os.path.join(os.path.dirname(jax_server.__file__), "static")
        for route, name in (("/", "index.html"), ("/static/app.js", "app.js"),
                            ("/static/viewer.js", "viewer.js")):
            code, _, data = _request(url + route)
            with open(os.path.join(static, name), "rb") as f:
                assert code == 200 and data == f.read()
        assert _request(url + "/static/nope.js")[0] == 404
        code, headers, data = _request(url + "/api/mesh", {"i": 2, "coloring": "patch"}, True)
        assert code == 200 and headers["Content-Encoding"] == "gzip"
        assert json.loads(gzip.decompress(data)) == server.handle_api(
            st, "/api/mesh", {"i": 2, "coloring": "patch"})
        code, headers, data = _request(url + "/api/info", {})
        assert code == 200 and "Content-Encoding" not in headers
        assert json.loads(data)["n"] == N
        code, _, data = _request(url + "/api/view_file", {"path": str(tmp_path / "x.off")})
        assert code == 500 and "outside" in json.loads(data)["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def test_build_applies_the_command_line(tmp_path):
    srv = server.build(["--no_autoload", "--port", "0", "--device", "cpu", "--allow_dir",
                        str(tmp_path)])
    try:
        assert srv.state.device.type == "cpu" and srv.state.dataset is None
        assert srv.state.allowed_roots == [os.path.realpath(tmp_path)]
        assert srv.server_address[0] == "127.0.0.1"
    finally:
        srv.server_close()
    # without --no_autoload it loads as /api/load does: here there is no checkpoint
    with pytest.raises(FileNotFoundError, match="available"):
        server.build(["--port", "0", "--device", "cpu", "--logDir", str(tmp_path),
                      "--synthetic", str(N), "--subdivision", str(S)])

"""The latent-space explorer: a JSON API over an ``AppState`` and its HTTP server.

Port of ``geniconet_tpu/app/server.py``: a stdlib ``http.server`` that
serves the single-page frontend (``static/``: the JAX package's
``index.html``, ``app.js`` and ``viewer.js``, copied) and answers every
route of the JAX ``handle_api``: ``/api/load`` (a checkpoint under the
body's ``logDir``, with the JAX body keys), ``/api/epochs``, ``/api/info``,
``/api/viewpoint`` (saved cameras in ``viewpoints.json`` next to the
model's logs, the JAX package's file), ``/api/mesh``, ``/api/interpolate``,
``/api/arithmetic`` (with the PCA nearest neighbour), ``/api/explore``,
``/api/regenerate`` (a VAE's), ``/api/patch_combine``, ``/api/decode``,
``/api/pca``, ``/api/pca_decode``, ``/api/pairs``, ``/api/view_file`` and
``/api/export``. The state is an argument, not a module global; the file
routes read and write only under its ``allowed_roots`` (the loaded log and
data directories, and ``--allow_dir``). Every decode runs on the state's
device: the card unless ``--device cpu``.

Usage:
    python -m geniconet_tpu_torch.app.server --model ico2ico --logDir log \\
        [--dataDir D | --synthetic N] [--port 8050] [--device cpu]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from geniconet_tpu_torch.app.state import AppState
from geniconet_tpu_torch.data.offio import write_off
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.config import Config

__all__ = ["handle_api", "mesh_payload", "Handler", "ExplorerServer", "make_server", "build",
           "main"]

STATIC = os.path.join(os.path.dirname(__file__), "static")
GZIP_BYTES = 16384  # larger bodies go gzipped to a client that accepts it


def _allow_root(st: AppState, path: str):
    if path:
        st.allowed_roots.append(os.path.realpath(path))


def _check_path(st: AppState, path: str) -> str:
    """Resolve ``path`` and require it under one of the state's allowed roots."""
    rp = os.path.realpath(path)
    for root in st.allowed_roots:
        if rp == root or rp.startswith(root + os.sep):
            return rp
    raise PermissionError(f"path outside the configured data/log roots: {path!r}")


def _unique_path(path: str) -> str:
    """Collision-free renaming: foo.off exists -> foo_1.off, foo_2.off, ...
    (reference save_figure semantics, visualizer_utils.py:163-192)."""
    if not os.path.exists(path):
        return path
    base, ext = os.path.splitext(path)
    k = 1
    while os.path.exists(f"{base}_{k}{ext}"):
        k += 1
    return f"{base}_{k}{ext}"


def mesh_payload(vertices: np.ndarray, faces: np.ndarray, colors: np.ndarray) -> dict:
    return {
        "vertices": np.asarray(vertices, np.float32).round(5).ravel().tolist(),
        "faces": np.asarray(faces, np.int32).ravel().tolist(),
        "colors": np.asarray(colors, np.float32).round(4).ravel().tolist(),
    }


def available_epochs(cfg) -> dict:
    """The epochs of ``cfg``'s model with a checkpoint, ``{"best", "periodic"}``."""
    return ckpt.available_epochs(os.path.join(cfg.model_log_dir(), "savedModel"), cfg.model.name)


def _viewpoints(st: AppState, body: dict) -> dict:
    """Saved camera viewpoints (reference update_viewpoint_list, app.py:612-628):
    op=save stores {name: camera}, op=delete drops one, op=list returns them;
    kept as JSON next to the model's logs."""
    path = os.path.join(st.cfg.model_log_dir(), "viewpoints.json")
    vps = {}
    if os.path.exists(path):
        with open(path) as f:
            vps = json.load(f)
    op = body.get("op", "list")
    if op in ("save", "delete"):
        if op == "save":
            vps[str(body["name"])[:64]] = body["camera"]
        else:
            vps.pop(str(body.get("name", "")), None)
        with open(path, "w") as f:
            json.dump(vps, f)
    return {"viewpoints": vps}


def _export(st: AppState, body: dict, faces, coloring: str) -> dict:
    """Mesh ``i``'s reconstruction as an ``.off`` file (fmt ``off``) or as the
    renderable figure in JSON (fmt ``fig``: vertices, faces, colors,
    coloring, name; the reference's plotly figure export), never over an
    existing file."""
    i = int(body["i"])
    v = st.reconstruct(i)
    out_dir = _check_path(st, body.get("dir", os.path.join(st.cfg.model_log_dir(), "export")))
    os.makedirs(out_dir, exist_ok=True)
    name = st.dataset.names[i]
    if body.get("fmt", "off") == "fig":
        fig = mesh_payload(v, faces, st.colorize(v, coloring))
        fig["coloring"], fig["name"] = coloring, name
        path = _unique_path(os.path.join(out_dir, f"{name}_recon.fig.json"))
        with open(path, "w") as f:
            json.dump(fig, f)
    else:
        path = _unique_path(os.path.join(out_dir, f"{name}_recon.off"))
        write_off(path, v, faces)
    return {"path": path}


def handle_api(st: AppState, path: str, body: dict) -> dict:
    """Answer one API request against the state."""
    if path == "/api/load":
        cfg = Config()
        cfg.model.name = body.get("model", "ico2ico")
        cfg.model.subdivisions = int(body.get("subdivision", 5))
        if body.get("widths"):
            cfg.model.widths = tuple(body["widths"])
        cfg.log_dir = body.get("logDir", "log")
        cfg.data.data_dir = body.get("dataDir", "")
        cfg.data.synthetic = int(body.get("synthetic", 0))
        cfg.data.layout_level = int(body.get("dataPthLvl", 2))
        info = st.load(cfg, body.get("instance", "val"), epoch=int(body.get("epoch", 0)))
        _allow_root(st, cfg.log_dir)
        _allow_root(st, cfg.data.data_dir)
        info["epochs"] = available_epochs(cfg)
        return info
    if st.cfg is None or st.dataset is None:
        raise RuntimeError("no model loaded: POST /api/load first")
    if path == "/api/epochs":  # reference update_epoch_list, app.py:54-96
        return available_epochs(st.cfg)
    if path == "/api/info":
        return st.info
    if path == "/api/viewpoint":
        return _viewpoints(st, body)
    faces = st.faces()
    coloring = body.get("coloring", "selfintersection")
    if path == "/api/mesh":
        i = int(body["i"])
        ref = st.reference_vertices(i)
        v = ref if body.get("which", "recon") == "reference" else st.reconstruct(i)
        return mesh_payload(v, faces, st.colorize(v, coloring, ref))
    if path == "/api/interpolate":
        v = st.interpolate(int(body["i"]), int(body["j"]), float(body["t"]))
        return mesh_payload(v, faces, st.colorize(v, coloring))
    if path == "/api/arithmetic":
        v, z = st.arithmetic([(t["op"], int(t["i"])) for t in body["terms"]])
        out = mesh_payload(v, faces, st.colorize(v, coloring))
        # the combined latent's nearest dataset latent in the PCA space (app.py:998-1050)
        idx = st.latent_nearest(z)
        out["nearest"] = {"index": idx, "name": st.dataset.names[idx]}
        return out
    if path == "/api/explore":
        v = st.explore_channel(int(body["i"]), int(body["channel"]), float(body["delta"]),
                               float(body.get("noise", 0.0)), int(body.get("seed", 0)))
        return mesh_payload(v, faces, st.colorize(v, coloring))
    if path == "/api/regenerate":
        v = st.regenerate(int(body["i"]), float(body["k"]), int(body.get("seed", 0)))
        return mesh_payload(v, faces, st.colorize(v, coloring))
    if path == "/api/patch_combine":
        v = st.patch_combine(int(body["i"]), int(body["j"]), list(body["patches"]))
        return mesh_payload(v, faces, st.colorize(v, "patch"))
    if path == "/api/decode":
        # {"indices": [...]} decodes cached latents; {"z": (N, Hz, Wz, C)} given ones
        if "indices" in body:
            zs = st.latents[np.asarray(body["indices"], np.int64)]
        else:
            zs = np.asarray(body["z"], np.float32)
            if zs.ndim == 3:
                zs = zs[None]
        vs = st.decode_batch(zs)
        return {"vertices": vs.round(5).tolist(), "faces": faces.ravel().tolist()}
    if path == "/api/pca":
        return st.pca_scatter()
    if path == "/api/pca_decode":
        v, idx = st.pca_nearest_decode(body["p"])
        out = mesh_payload(v, faces, st.colorize(v, coloring))
        out["index"], out["name"] = idx, st.dataset.names[idx]
        return out
    if path == "/api/pairs":
        return {"pairs": st.closest_pairs(int(body.get("k", 5)),
                                          bool(body.get("farthest", False)))}
    if path == "/api/view_file":
        v, f = st.view_file(_check_path(st, body["path"]))
        colors = np.tile(np.array([0.62, 0.66, 0.72], np.float32), (len(v), 1))
        return mesh_payload(v, f, colors)
    if path == "/api/export":
        return _export(st, body, faces, coloring)
    raise ValueError(f"unknown endpoint {path}")


class ExplorerServer(ThreadingHTTPServer):
    """The HTTP server of one ``AppState``: its requests run ``handle_api``
    one at a time under ``lock``."""

    daemon_threads = True

    def __init__(self, address, state: AppState):
        super().__init__(address, Handler)
        self.state = state
        self.lock = threading.Lock()


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, content: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        # mesh payloads are megabytes of JSON: gzip when the client accepts it
        ae = self.headers.get("Accept-Encoding", "")
        accepts_gzip = "gzip" in ae and "gzip;q=0" not in ae.replace(" ", "")
        if len(content) > GZIP_BYTES and accepts_gzip:
            content = gzip.compress(content, compresslevel=4)
            self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(content)))
        self.end_headers()
        self.wfile.write(content)

    def do_GET(self):
        path = self.path.split("?")[0]
        if path in ("/", "/index.html"):
            with open(os.path.join(STATIC, "index.html"), "rb") as f:
                return self._send(200, f.read(), "text/html")
        if path.startswith("/static/"):
            fp = os.path.join(STATIC, os.path.basename(path))
            if os.path.exists(fp):
                ctype = "text/javascript" if fp.endswith(".js") else "text/css"
                with open(fp, "rb") as f:
                    return self._send(200, f.read(), ctype)
        return self._send(404, b"not found", "text/plain")

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            with self.server.lock:
                out = handle_api(self.server.state, self.path, body)
            self._send(200, json.dumps(out).encode(), "application/json")
        except Exception as e:
            traceback.print_exc()
            self._send(500, json.dumps({"error": str(e)}).encode(), "application/json")


def make_server(st: AppState, host: str = "127.0.0.1", port: int = 8050) -> ExplorerServer:
    """An ``ExplorerServer`` of ``st`` bound to (host, port); port 0 takes a free one."""
    return ExplorerServer((host, port), st)


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="ico2ico")
    p.add_argument("--logDir", default="log")
    p.add_argument("--dataDir", default="")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--subdivision", type=int, default=5)
    p.add_argument("--port", type=int, default=8050)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; pass 0.0.0.0 to opt into network exposure")
    p.add_argument("--allow_dir", action="append", default=[],
                   help="extra root(s) the file viewer/exporter may access")
    p.add_argument("--no_autoload", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda; 'cpu' runs the plain "
                        "versions)")
    return p


def build(argv=None) -> ExplorerServer:
    """The server ``main`` runs, from its command line: the state on
    ``--device``, the ``--allow_dir`` roots, and unless ``--no_autoload`` the
    model loaded as ``/api/load`` loads it."""
    a = _parser().parse_args(argv)
    st = AppState(device=a.device)
    for d in a.allow_dir:
        _allow_root(st, d)
    if not a.no_autoload:
        info = handle_api(st, "/api/load", {"model": a.model, "logDir": a.logDir,
                                            "dataDir": a.dataDir, "synthetic": a.synthetic,
                                            "subdivision": a.subdivision})
        print(f"loaded: {info['n']} meshes, epoch {info['epoch']}", flush=True)
    return make_server(st, a.host, a.port)


def main(argv=None):
    srv = build(argv)
    host, port = srv.server_address[:2]
    print(f"GenIcoNet explorer on http://{host}:{port}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()

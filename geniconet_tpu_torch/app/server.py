"""JSON API of the latent-space explorer over an ``AppState``.

Port of ``geniconet_tpu/app/server.py:handle_api`` for the routes the
ported state serves: ``/api/load`` (a checkpoint under the body's
``logDir``, with the JAX body keys), ``/api/epochs``, ``/api/info``,
``/api/mesh``, ``/api/interpolate``, ``/api/arithmetic`` (without the PCA
nearest neighbour), ``/api/explore``, ``/api/regenerate`` (a VAE's),
``/api/patch_combine`` and ``/api/decode``. The state is an argument, not a
module global. The PCA routes (``/api/pca``, ``/api/pca_decode``,
``/api/pairs``) wait for later work (ROADMAP, Queue 1 item 10).
"""

from __future__ import annotations

import os

import numpy as np

from geniconet_tpu_torch.app.state import AppState
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.config import Config

__all__ = ["handle_api", "mesh_payload"]

_LATER = {
    "/api/pca": "PCA routes (ROADMAP, Queue 1 item 10)",
    "/api/pca_decode": "PCA routes (ROADMAP, Queue 1 item 10)",
    "/api/pairs": "PCA routes (ROADMAP, Queue 1 item 10)",
}


def mesh_payload(vertices: np.ndarray, faces: np.ndarray, colors: np.ndarray) -> dict:
    return {
        "vertices": np.asarray(vertices, np.float32).round(5).ravel().tolist(),
        "faces": np.asarray(faces, np.int32).ravel().tolist(),
        "colors": np.asarray(colors, np.float32).round(4).ravel().tolist(),
    }


def available_epochs(cfg) -> dict:
    """The epochs of ``cfg``'s model with a checkpoint, ``{"best", "periodic"}``."""
    return ckpt.available_epochs(os.path.join(cfg.model_log_dir(), "savedModel"), cfg.model.name)


def handle_api(st: AppState, path: str, body: dict) -> dict:
    """Answer one API request against the loaded state."""
    if path in _LATER:
        raise NotImplementedError(f"{path} is not ported yet: {_LATER[path]}")
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
        info["epochs"] = available_epochs(cfg)
        return info
    if st.dataset is None:
        raise RuntimeError("no model loaded: POST /api/load first")
    if path == "/api/epochs":  # reference update_epoch_list, app.py:54-96
        return available_epochs(st.cfg)
    if path == "/api/info":
        return st.info
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
        v, _ = st.arithmetic([(t["op"], int(t["i"])) for t in body["terms"]])
        return mesh_payload(v, faces, st.colorize(v, coloring))
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
    raise ValueError(f"unknown endpoint {path}")

"""Latent-space explorer backend: the model, the latent cache, decode paths.

Port of ``geniconet_tpu/app/state.py`` for the autoencoder and the VAE:
``load`` builds the dataset, loads the model from a checkpoint under
``<logDir>/<ae|vae>/savedModel`` (or from a flax variable tree) and encodes
the dataset into a float32 latent cache in batches of 16 (the VAE's cache
holds mu, and ``logvars`` its logvar); the decode paths (reconstruct,
interpolate, arithmetic, per-channel exploration, the VAE's regeneration,
patch combination, batched decode) return float32 ``(V, 3)`` vertices.
Every decode runs the model on ``device``: the card by default (the CUDA
kernels), the plain versions with ``device="cpu"``.

PCA(3) of the latent cache (``fit_pca``: the SVD of the centred float32
latents, each component's sign as scikit-learn >= 1.5 fixes it, cached on
disk as ``.npz``), the exact nearest dataset latent by a brute-force
search over the PCA points, the closest and farthest pairs, and the file
viewer's ``.off`` / ``.ply`` / ``.npz`` reader (reference app.py:255-279,
383-409, 998-1050, 1266-1296). The JAX package's int16 decode transfer and
power-of-two batch buckets (TPU compile reuse) have no counterpart here.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from geniconet_tpu_torch import device as devices
from geniconet_tpu_torch import native
from geniconet_tpu_torch.bridge import flax_to_state_dict
from geniconet_tpu_torch.data.datasets import IcoDataset, load_ico_npz, synthetic_dataset
from geniconet_tpu_torch.data.offio import read_off, read_ply
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
from geniconet_tpu_torch.ops.vertices import grid_to_vertices
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.config import Config

__all__ = ["AppState", "checkpoint_for", "pca_fit", "pca_transform"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ENCODE_BATCH = 16


def checkpoint_for(cfg: Config, epoch: int = 0) -> str:
    """The checkpoint the explorer loads for ``epoch``, as the JAX
    ``AppState.load`` resolves it (reference app.py:54-96): 0 is the newest
    EB file; a positive epoch its EB file, else its E file. Raises
    ``FileNotFoundError`` (listing the epochs there are) when there is none."""
    name = cfg.model.name
    ckpt_dir = os.path.join(cfg.model_log_dir(), "savedModel")
    if epoch:
        for best in (True, False):
            path = ckpt.checkpoint_path(ckpt_dir, name, int(epoch), best=best)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no checkpoint for epoch {epoch} under {ckpt_dir} "
                                f"(available: {ckpt.available_epochs(ckpt_dir, name)})")
    best = ckpt.latest_best_epoch(ckpt_dir, name)
    if best is None:
        raise FileNotFoundError(f"no EB checkpoint under {ckpt_dir} "
                                f"(available: {ckpt.available_epochs(ckpt_dir, name)})")
    return ckpt.checkpoint_path(ckpt_dir, name, best, best=True)


def pca_fit(flat: np.ndarray, n_components: int = 3) -> dict:
    """PCA of the rows of ``flat`` (N, D) as scikit-learn's ``PCA`` fits it:
    the SVD of the centred float32 rows, each component's sign fixed so its
    largest-magnitude entry is positive (``svd_flip(u_based_decision=
    False)``, scikit-learn >= 1.5). Returns float32 ``mean`` (D,),
    ``components`` (k, D) and ``points`` (N, k), the rows' coordinates
    (``fit_transform``: U·S)."""
    x = torch.from_numpy(np.ascontiguousarray(flat, np.float32))
    mean = x.mean(dim=0)
    u, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
    k = min(n_components, vt.shape[0])
    u, s, vt = u[:, :k], s[:k], vt[:k]
    signs = torch.sign(vt.gather(1, vt.abs().argmax(dim=1, keepdim=True)))
    return {"mean": mean.numpy(), "components": (vt * signs).numpy(),
            "points": (u * signs.T * s).numpy().astype(np.float32)}


def pca_transform(pca: dict, flat: np.ndarray) -> np.ndarray:
    """(z - mean) @ components.T of rows ``flat`` (n, D), in float64 (as
    scikit-learn's ``transform`` runs on float64 input)."""
    return (np.asarray(flat, np.float64) - pca["mean"]) @ pca["components"].astype(np.float64).T


class AppState:
    def __init__(self, device="cuda"):
        self.device = devices.resolve(device)
        self.info = None
        self.instance = "val"
        self.epoch = None
        self.cfg: Config | None = None
        self.model: IcoAE | IcoVAE | None = None
        self.dataset: IcoDataset | None = None
        self.latents: np.ndarray | None = None  # (N, Hz, Wz, C) float32; the VAE's mu
        self.logvars: np.ndarray | None = None  # the VAE's logvar, else None
        self.pca: dict | None = None             # pca_fit's mean, components, points
        self.pca_points: np.ndarray | None = None
        # directories /api/view_file may read and /api/export write under
        # (server.py: the loaded log and data directories, --allow_dir)
        self.allowed_roots: list[str] = []

    def load(self, cfg: Config, data_instance: str = "val", epoch: int = 0, *, variables=None,
             phase_chain: str | None = None):
        """Build the dataset, load the model and encode the latent cache.
        Returns the info dict that ``/api/info`` serves.

        The weights come from the checkpoint of ``epoch`` (``checkpoint_for``:
        0 the newest EB file, else that epoch's EB file, then its E file),
        or, given ``variables`` (a flax ``{"params", "batch_stats"}`` tree of
        arrays), from that tree, ``epoch`` then only labelling them.
        ``phase_chain`` ("enc", "dec" or "1") runs the encoder's, the
        decoder's or both halves' phase chain for every encode and decode
        (``nn/models.py``)."""
        if variables is None:
            blob = ckpt.load_checkpoint(checkpoint_for(cfg, epoch))
            variables = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
            epoch = int(blob["epoch"])
        self.cfg, self.instance, s = cfg, data_instance, cfg.model.subdivisions
        if cfg.data.synthetic:
            self.dataset = synthetic_dataset(s, cfg.data.synthetic, seed=cfg.data.synthetic_seed)
        else:
            self.dataset = IcoDataset.from_directory(
                cfg.data.data_dir, s, cfg.data.layout_level, data_instance, cfg.data.ext,
                cfg.train.quick_learn)
        m, dtype = cfg.model, _DTYPES[cfg.model.compute_dtype]
        if m.is_vae:
            model = IcoVAE(s, tuple(m.widths), m.latent_features, m.corner_mode, dtype,
                           phase_chain=phase_chain, device=self.device)
        else:
            model = IcoAE(s, tuple(m.widths), m.corner_mode, dtype, phase_chain=phase_chain,
                          device=self.device)
        model.load_state_dict(flax_to_state_dict(variables))
        self.model = model.eval()
        encoded = [self._encode(self.dataset.inputs[i : i + ENCODE_BATCH])
                   for i in range(0, len(self.dataset), ENCODE_BATCH)]
        if m.is_vae:
            self.latents = np.concatenate([mu for mu, _ in encoded])
            self.logvars = np.concatenate([lv for _, lv in encoded])
        else:
            self.latents, self.logvars = np.concatenate(encoded), None
        self.epoch, self.pca, self.pca_points = epoch, None, None
        self.info = {
            "n": len(self.dataset),
            "names": self.dataset.names,
            "classes": self.dataset.classes,
            "epoch": epoch,
            "latent_shape": list(self.latents.shape[1:]),
            "is_vae": m.is_vae,
            "subdivisions": s,
            "model": cfg.model.name,
            "logDir": cfg.log_dir,
            "dataDir": cfg.data.data_dir,
            "synthetic": cfg.data.synthetic,
            "instance": data_instance,
        }
        return self.info

    # ------------------------------------------------------------------
    # model calls
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _encode(self, grids: np.ndarray):
        """Float32 latents of a batch of grids; the VAE's (mu, logvar)."""
        x = torch.as_tensor(grids, dtype=torch.float32, device=self.device)
        out = self.model.encode(x)
        if isinstance(out, tuple):
            return tuple(t.float().cpu().numpy() for t in out)
        return out.float().cpu().numpy()

    @torch.inference_mode()
    def decode_batch(self, zs: np.ndarray) -> np.ndarray:
        """(N, Hz, Wz, C) latents -> (N, V, 3) float32 vertices, one batched call."""
        z = torch.as_tensor(np.asarray(zs, np.float32), device=self.device)
        out = self.model.decode(z)
        return grid_to_vertices(out, self.cfg.model.subdivisions).cpu().numpy()

    def decode_latent(self, z: np.ndarray) -> np.ndarray:
        """(Hz, Wz, C) latent -> (V, 3) vertices."""
        return self.decode_batch(z[None])[0]

    # ------------------------------------------------------------------
    # decode paths
    # ------------------------------------------------------------------

    def interpolate(self, i: int, j: int, t: float) -> np.ndarray:
        return self.decode_latent((1.0 - t) * self.latents[i] + t * self.latents[j])

    def arithmetic(self, terms: list[tuple[str, int]]):
        """terms: [('+', i), ('-', j), ...] over dataset latents -> (vertices, z)."""
        z = np.zeros_like(self.latents[0])
        for op, idx in terms:
            z = z + self.latents[idx] if op == "+" else z - self.latents[idx]
        return self.decode_latent(z), z

    def explore_channel(self, i: int, channel: int, delta: float, noise: float = 0.0,
                        seed: int = 0) -> np.ndarray:
        """Shift one latent channel by delta·sigma (+ optional noise), decode;
        sigma is the per-channel std over the dataset latents."""
        z = self.latents[i].copy()
        sigma = self.latents.std(axis=0)
        z[..., channel] += delta * sigma[..., channel].mean()
        if noise:
            z += noise * sigma * np.random.RandomState(seed).randn(*z.shape)
        return self.decode_latent(z)

    def regenerate(self, i: int, k: float, seed: int = 0) -> np.ndarray:
        """The VAE's re-generation z = mu + k·σ·ε, ε from ``RandomState(seed)``
        (reference app.py:929-948)."""
        if self.logvars is None:
            raise ValueError("regeneration requires a VAE model")
        std = np.exp(0.5 * self.logvars[i])
        z = self.latents[i] + k * std * np.random.RandomState(seed).randn(*std.shape).astype(
            np.float32)
        return self.decode_latent(z)

    def patch_combine(self, i: int, j: int, take_from_j: list[int]) -> np.ndarray:
        """Rows of latent chart c come from j if c is in take_from_j."""
        hz = 2 ** (self.cfg.model.subdivisions - 3)
        z = self.latents[i].copy()
        for c in take_from_j:
            z[c * hz : (c + 1) * hz] = self.latents[j][c * hz : (c + 1) * hz]
        return self.decode_latent(z)

    def reconstruct(self, i: int) -> np.ndarray:
        return self.decode_latent(self.latents[i])

    # ------------------------------------------------------------------
    # PCA + nearest neighbour (reference app.py:255-279, 383-409)
    # ------------------------------------------------------------------

    def fit_pca(self, cache_path: str | None = None):
        """Fit ``pca_fit`` to the flattened latent cache once, or read the
        fit from ``cache_path`` (an ``.npz`` of mean, components and points,
        refit when its point count is not the cache's). The fit is written
        there where the model's log directory exists (a state loaded from
        variables in memory may have none)."""
        if self.pca is not None:
            return
        if cache_path and os.path.exists(cache_path):
            with np.load(cache_path) as f:
                pca = {k: f[k] for k in ("mean", "components", "points")}
            if len(pca["points"]) == len(self.latents):
                self.pca = pca
        if self.pca is None:
            self.pca = pca_fit(self.latents.reshape(len(self.latents), -1))
            if cache_path and os.path.isdir(os.path.dirname(cache_path)):
                tmp = cache_path + ".tmp.npz"
                np.savez(tmp, **self.pca)
                os.replace(tmp, cache_path)
        self.pca_points = self.pca["points"]

    def _pca_cache_path(self):
        """The on-disk PCA cache, keyed as the JAX package keys its pickle
        (checkpoint epoch, data instance, count and a fingerprint of the
        data directory, synthetic count, quick-learn setting and mesh
        names), with its own suffix ``.pca.npz``: neither package reads the
        other's file."""
        if self.cfg is None:
            return None
        h = hashlib.sha1()
        h.update(self.cfg.data.data_dir.encode())
        h.update(str(self.cfg.data.synthetic).encode())
        h.update(str(self.cfg.train.quick_learn).encode())
        for name in self.dataset.names:
            h.update(name.encode())
            h.update(b"\0")
        return os.path.join(
            self.cfg.model_log_dir(),
            f"pca_{self.cfg.model.name}_e{self.epoch}_{self.instance}"
            f"_n{len(self.dataset)}_{h.hexdigest()[:10]}.pca.npz")

    def pca_scatter(self):
        self.fit_pca(self._pca_cache_path())
        return {"points": self.pca_points.tolist(), "classes": self.dataset.classes,
                "names": self.dataset.names}

    def nearest(self, p3) -> int:
        """The dataset latent whose PCA point is nearest ``p3`` (3,): an
        exact brute-force search in float64, the first of equals."""
        self.fit_pca(self._pca_cache_path())
        d = ((self.pca_points.astype(np.float64) - np.asarray(p3, np.float64)) ** 2).sum(axis=1)
        return int(np.argmin(d))

    def latent_nearest(self, z: np.ndarray) -> int:
        """The dataset latent nearest latent ``z`` in the PCA space."""
        self.fit_pca(self._pca_cache_path())
        return self.nearest(pca_transform(self.pca, z.reshape(1, -1))[0])

    def pca_nearest_decode(self, p3: list[float]):
        """Nearest dataset latent to a 3-D PCA point (taken as float32), decoded."""
        idx = self.nearest(np.asarray(p3, np.float32))
        return self.decode_latent(self.latents[idx]), idx

    def closest_pairs(self, k: int = 5, farthest: bool = False):
        """Top-k closest/farthest PCA pairs (reference app.py:383-409)."""
        self.fit_pca(self._pca_cache_path())
        p = self.pca_points
        d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
        iu = np.triu_indices(len(p), 1)
        order = np.argsort(d[iu])
        if farthest:
            order = order[::-1]
        return [{"i": int(iu[0][t]), "j": int(iu[1][t]), "d": float(d[iu][t])}
                for t in order[:k]]

    # ------------------------------------------------------------------
    # mesh assembly + colorings
    # ------------------------------------------------------------------

    def faces(self) -> np.ndarray:
        return ico.get_ico_faces(self.cfg.model.subdivisions)

    def reference_vertices(self, i: int) -> np.ndarray:
        return self.dataset.targets[i, :, :3]

    def colorize(self, vertices: np.ndarray, mode: str, ref: np.ndarray | None = None):
        """Per-vertex RGB in [0, 1] for the requested coloring mode."""
        V = vertices.shape[0]
        if mode == "patch":
            palette = np.array(
                [[0.84, 0.37, 0.0], [0.0, 0.62, 0.45], [0.34, 0.71, 0.91],
                 [0.94, 0.89, 0.26], [0.8, 0.47, 0.65], [0.9, 0.9, 0.9],
                 [0.5, 0.5, 0.5]], np.float32,
            )
            return palette[ico.get_patch_ids(self.cfg.model.subdivisions)]
        if mode == "distance" and ref is not None:
            d = np.linalg.norm(vertices - ref, axis=1)
            dn = np.clip(d / max(d.mean() * 3.0, 1e-9), 0, 1)[:, None]
            base = np.array([0.7, 0.7, 0.75], np.float32)
            red = np.array([0.9, 0.1, 0.1], np.float32)
            return (1 - dn) * base + dn * red
        if mode == "selfintersection":
            colors = np.tile(np.array([0.62, 0.66, 0.72], np.float32), (V, 1))
            pairs = native.detect_self_intersection(vertices, self.faces())
            if len(pairs):
                colors[np.unique(self.faces()[np.unique(pairs.ravel())].ravel())] = [
                    0.95, 0.15, 0.1]
            return colors
        return np.tile(np.array([0.62, 0.66, 0.72], np.float32), (V, 1))

    def view_file(self, path: str):
        """The file viewer (reference app.py:1266-1296): an ``.off`` or
        ``.ply`` mesh, or an ``.npz`` sample's positions on the loaded
        level's faces -> (vertices (V, 3), faces (F, 3))."""
        if path.endswith(".off"):
            return read_off(path)
        if path.endswith(".ply"):
            return read_ply(path)
        if path.endswith(".npz"):
            s = self.cfg.model.subdivisions if self.cfg else 5
            _, target = load_ico_npz(path, s)
            return target[:, :3], ico.get_ico_faces(s)
        raise ValueError(f"unsupported file type: {path}")

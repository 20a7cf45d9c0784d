"""Latent-space explorer backend: the model, the latent cache, decode paths.

Port of ``geniconet_tpu/app/state.py`` for the autoencoder and the VAE:
``load`` builds the dataset, loads the model from a flax variable tree and
encodes the dataset into a float32 latent cache in batches of 16 (the VAE's
cache holds mu, and ``logvars`` its logvar); the decode paths (reconstruct,
interpolate, arithmetic, per-channel exploration, the VAE's regeneration,
patch combination, batched decode) return float32 ``(V, 3)`` vertices.
Every decode runs the model on ``device``: the card by default (the CUDA
kernels), the plain versions with ``device="cpu"``.

Not ported here: reading ``.ckpt`` checkpoints (ROADMAP, Queue 1); PCA and
nearest neighbours (they need scikit-learn); the TPU-specific int16 decode
transfer and power-of-two batch bucketing.
"""

from __future__ import annotations

import numpy as np
import torch

from geniconet_tpu_torch import device as devices
from geniconet_tpu_torch import native
from geniconet_tpu_torch.bridge import flax_to_state_dict
from geniconet_tpu_torch.data.datasets import IcoDataset, synthetic_dataset
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
from geniconet_tpu_torch.ops.vertices import grid_to_vertices
from geniconet_tpu_torch.train.config import Config

__all__ = ["AppState"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ENCODE_BATCH = 16


class AppState:
    def __init__(self, device="cuda"):
        self.device = devices.resolve(device)
        self.info = None
        self.instance = "val"
        self.cfg: Config | None = None
        self.model: IcoAE | IcoVAE | None = None
        self.dataset: IcoDataset | None = None
        self.latents: np.ndarray | None = None  # (N, Hz, Wz, C) float32; the VAE's mu
        self.logvars: np.ndarray | None = None  # the VAE's logvar, else None

    def load(self, cfg: Config, variables=None, data_instance: str = "val", epoch: int = 0,
             phase_chain: str | None = None):
        """Build the dataset, load the model from ``variables`` (a flax
        ``{"params", "batch_stats"}`` tree of arrays) and encode the latent
        cache. ``phase_chain`` ("enc", "dec" or "1") runs the encoder's, the
        decoder's or both halves' phase chain for every encode and decode
        (``nn/models.py``). Returns the info dict that ``/api/info``
        serves."""
        if variables is None:
            raise NotImplementedError(
                "reading .ckpt checkpoints is not ported yet (ROADMAP, Queue 1 item 7: "
                "checkpoints); pass the variables tree")
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

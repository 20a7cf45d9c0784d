"""Latent-space explorer backend: the model, the latent cache, decode paths.

Port of ``geniconet_tpu/app/state.py`` for the autoencoder: ``load`` builds
the dataset, loads the model from a flax variable tree and encodes the
dataset into a float32 latent cache in batches of 16; the decode paths
(reconstruct, interpolate, arithmetic, per-channel exploration, patch
combination, batched decode) return float32 ``(V, 3)`` vertices. Every
decode runs the model on ``device``: the card by default (the CUDA
kernels), the plain versions with ``device="cpu"``.

Not ported here: reading ``.ckpt`` checkpoints and the VAE (ROADMAP, Queue
1); PCA and nearest neighbours (they need scikit-learn); the TPU-specific
int16 decode transfer and power-of-two batch bucketing.
"""

from __future__ import annotations

import numpy as np
import torch

from geniconet_tpu_torch import device as devices
from geniconet_tpu_torch import native
from geniconet_tpu_torch.bridge import flax_to_state_dict
from geniconet_tpu_torch.data.datasets import IcoDataset, synthetic_dataset
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.nn.models import IcoAE
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
        self.model: IcoAE | None = None
        self.dataset: IcoDataset | None = None
        self.latents: np.ndarray | None = None  # (N, Hz, Wz, C) float32

    def load(self, cfg: Config, variables=None, data_instance: str = "val", epoch: int = 0):
        """Build the dataset, load the model from ``variables`` (a flax
        ``{"params", "batch_stats"}`` tree of arrays) and encode the latent
        cache. Returns the info dict that ``/api/info`` serves."""
        if variables is None:
            raise NotImplementedError(
                "reading .ckpt checkpoints is not ported yet (ROADMAP, Queue 1 item 7: "
                "checkpoints); pass the variables tree")
        if cfg.model.is_vae:
            raise NotImplementedError("IcoVAE is not ported yet (ROADMAP, Queue 1 item 6: VAE)")
        self.cfg, self.instance, s = cfg, data_instance, cfg.model.subdivisions
        if cfg.data.synthetic:
            self.dataset = synthetic_dataset(s, cfg.data.synthetic, seed=cfg.data.synthetic_seed)
        else:
            self.dataset = IcoDataset.from_directory(
                cfg.data.data_dir, s, cfg.data.layout_level, data_instance, cfg.data.ext,
                cfg.train.quick_learn)
        model = IcoAE(s, tuple(cfg.model.widths), cfg.model.corner_mode,
                      _DTYPES[cfg.model.compute_dtype], device=self.device)
        model.load_state_dict(flax_to_state_dict(variables))
        self.model = model.eval()
        self.latents = np.concatenate([
            self._encode(self.dataset.inputs[i : i + ENCODE_BATCH])
            for i in range(0, len(self.dataset), ENCODE_BATCH)
        ])
        self.info = {
            "n": len(self.dataset),
            "names": self.dataset.names,
            "classes": self.dataset.classes,
            "epoch": epoch,
            "latent_shape": list(self.latents.shape[1:]),
            "is_vae": False,
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
    def _encode(self, grids: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(grids, dtype=torch.float32, device=self.device)
        return self.model.encode(x).float().cpu().numpy()

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

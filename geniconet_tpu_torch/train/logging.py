"""Training logs: a JSONL event file, and TensorBoard where it imports.

Port of ``geniconet_tpu/train/logging.py`` (reference run.py:97-231,
256-267): scalar streams every ``log_freq`` steps, mesh logging of fixed
validation samples coloured by their distance to the target, encoding
histograms and images, text. Every record goes to ``<log_dir>/events.jsonl``;
TensorBoard gets them too when ``torch.utils.tensorboard`` imports (it needs
the ``tensorboard`` package, which a machine may lack).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from geniconet_tpu_torch.geometry import ico

__all__ = ["Logger"]


class Logger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[logger] tensorboard unavailable ({e}); writing JSONL only")
            else:
                self.tb = SummaryWriter(log_dir=log_dir)
        self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")

    def scalars(self, prefix: str, values: dict, step: int):
        rec = {"t": time.time(), "step": step, "prefix": prefix, **values}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(f"{prefix}/{k}", v, step)

    def histogram(self, tag: str, values: np.ndarray, step: int):
        # summary stats always land in the JSONL stream (observable without
        # tensorboard; also what tests assert on); full histogram goes to TB
        v = np.asarray(values).ravel()
        rec = {
            "t": time.time(), "step": step, "prefix": tag,
            "mean": float(v.mean()), "std": float(v.std()),
            "min": float(v.min()), "max": float(v.max()),
        }
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.tb is not None:
            self.tb.add_histogram(tag, values, step)

    def images(self, tag: str, images: np.ndarray, step: int):
        """Log an (N, H, W, 1) image stack (reference writer.add_images with
        dataformats='NHWC', run.py:211). JSONL fallback records per-image
        stats so the stream stays observable without tensorboard."""
        arr = np.asarray(images, np.float32)
        self.scalars(
            tag + "_img",
            {"n": float(arr.shape[0]), "mean": float(arr.mean()),
             "std": float(arr.std())},
            step,
        )
        if self.tb is not None:
            try:
                import torch

                lo, hi = float(arr.min()), float(arr.max())
                norm = (arr - lo) / max(hi - lo, 1e-9)
                self.tb.add_images(tag, torch.from_numpy(norm), step,
                                   dataformats="NHWC")
            except Exception as e:
                print(f"[logger] add_images failed: {e}")

    def meshes(self, tag: str, pred_vertices, target_vertices, subdivisions: int, step: int):
        """Log predicted meshes colored by per-vertex distance to target
        (reference run.py:97-148: clamped distance -> color, plus mean
        distance scalars)."""
        pred = np.asarray(pred_vertices)
        tgt = np.asarray(target_vertices)
        dist = np.linalg.norm(pred - tgt, axis=-1)  # (B, V)
        self.scalars(
            f"{tag}_dist",
            {"mean": float(dist.mean()), "max": float(dist.max())},
            step,
        )
        if self.tb is None:
            return
        faces = ico.get_ico_faces(subdivisions)
        # clamp + normalize distances into a red-green colormap
        d = np.clip(dist / max(float(dist.mean()) * 3.0, 1e-9), 0.0, 1.0)
        colors = np.stack(
            [255 * d, 255 * (1 - d), np.zeros_like(d)], axis=-1
        ).astype(np.int32)
        try:
            import torch

            self.tb.add_mesh(
                tag,
                vertices=torch.from_numpy(pred.copy()),
                colors=torch.from_numpy(colors),
                faces=torch.from_numpy(np.broadcast_to(faces, (pred.shape[0],) + faces.shape).copy()),
                global_step=step,
            )
        except Exception as e:
            print(f"[logger] add_mesh failed: {e}")

    def text(self, tag: str, s: str, step: int = 0):
        if self.tb is not None:
            self.tb.add_text(tag, s, step)
        self._jsonl.write(json.dumps({"t": time.time(), "text": {tag: s}}) + "\n")

    def flush(self):
        self._jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()

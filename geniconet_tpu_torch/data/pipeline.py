"""Shuffled training batches from a dataset held on the device.

Port of ``geniconet_tpu/data/pipeline.py:Batches`` for one device: the
packed dataset is copied to ``device`` once and every batch is an index
gather there, so only the index array moves per step. The shuffle stream is
the JAX package's (``np.random.RandomState(seed)``, one shuffle per epoch),
so both packages see the same batches in the same order.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from geniconet_tpu_torch import device as devices
from geniconet_tpu_torch.data.datasets import IcoDataset

__all__ = ["Batches"]


class Batches:
    """Iterable over (inputs, targets, weights) batches on ``device``.

    inputs (B, H, W, 3) and targets (B, V, 9) float32; weights (B,) float32
    ones. ``drop_remainder`` False keeps the ragged last batch, as a torch
    DataLoader and the JAX Batches without sharding do. ``device``: the
    card by default; ``"cpu"`` for the CPU."""

    def __init__(self, dataset: IcoDataset, batch_size: int, shuffle: bool = True,
                 drop_remainder: bool = False, seed: int = 0, device="cuda"):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.device = devices.resolve(device)
        self._rng = np.random.RandomState(seed)
        self.inputs = torch.as_tensor(dataset.inputs, device=self.device)
        self.targets = torch.as_tensor(dataset.targets, device=self.device)

    def __len__(self):
        n = len(self.ds)
        if self.drop_remainder and n >= self.batch_size:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_indices(self) -> Iterator[tuple]:
        """Yield (idx, wt) host arrays for one epoch."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for i in range(len(self)):
            idx = order[i * bs : (i + 1) * bs]
            yield idx, np.ones(len(idx), np.float32)

    def epoch(self) -> Iterator[tuple]:
        """Yield (inputs, targets, weights) for one epoch, gathered on the device."""
        for idx, wt in self.epoch_indices():
            i = torch.as_tensor(idx, device=self.device)
            yield self.inputs[i], self.targets[i], torch.as_tensor(wt, device=self.device)

"""Shuffled training batches from a dataset held on the device.

Port of ``geniconet_tpu/data/pipeline.py:Batches``: the packed dataset is
copied to ``device`` once and every batch is an index gather there. An
epoch's whole schedule (every batch's indices and weights) is built on the
host when its first batch is requested and moves to a card in one
asynchronous copy from pinned memory; each batch is then a slice of it, so
nothing in an epoch waits on the device. The shuffle stream is the JAX
package's (``np.random.RandomState(seed)``, one shuffle per epoch started),
so both packages see the same batches in the same order.

Data parallelism (``world`` ranks; the JAX ``sharding``): ``batch_size`` is
the global batch, which ``world`` must divide. Every rank shuffles with the
same seed and takes its contiguous slice of each global batch (shard i of
``data_sharding``). A ragged training batch is cut to a multiple of the
world (zero weights cannot mask the BatchNorm moments), and the training
loader drops the ragged tail by default; a ragged eval batch is padded to
a multiple of the world with zero-weight rows that repeat sample 0.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from geniconet_tpu_torch import device as devices
from geniconet_tpu_torch import tracing
from geniconet_tpu_torch.data.datasets import IcoDataset
from geniconet_tpu_torch.parallel.dist import shard_slice

__all__ = ["Batches", "pad_to_multiple"]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Batches:
    """Iterable over (inputs, targets, weights) batches on ``device``.

    inputs (B, H, W, 3) and targets (B, V, 9) float32; weights (B,) float32
    (ones, and zeros on an eval batch's padding). ``drop_remainder`` None is
    the JAX default: drop the ragged last batch when shuffling a sharded
    loader, else keep it, as a torch DataLoader does. ``rank``, ``world``:
    this rank of a data-parallel run over ``world`` ranks (module doc);
    ``world`` None for one process. ``device``: the card by default;
    ``"cpu"`` for the CPU."""

    def __init__(self, dataset: IcoDataset, batch_size: int, shuffle: bool = True,
                 drop_remainder: bool | None = None, seed: int = 0, device="cuda",
                 rank: int = 0, world: int | None = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rank, self.world = rank, world
        if world is not None and batch_size % world:
            raise ValueError(f"global batch_size {batch_size} must be divisible by the {world} "
                             f"ranks (the batch of each must be the same); pick e.g. "
                             f"{pad_to_multiple(batch_size, world)}")
        if drop_remainder is None:
            drop_remainder = shuffle and world is not None
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

    def global_indices(self) -> Iterator[tuple]:
        """Yield the global batches' (idx, wt) host arrays for one epoch
        (the JAX ``epoch_indices``)."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            self._rng.shuffle(order)
        bs, world = self.batch_size, self.world
        for i in range(len(self)):
            idx = order[i * bs : (i + 1) * bs]
            if len(idx) < bs and world is not None and self.shuffle:
                keep = (len(idx) // world) * world
                if keep == 0:
                    raise ValueError(f"dataset slice of {len(idx)} samples cannot feed "
                                     f"{world} ranks; add data or use fewer ranks")
                idx = idx[:keep]
            wt = np.ones(len(idx), np.float32)
            if len(idx) < bs and world is not None and not self.shuffle:
                pad = pad_to_multiple(len(idx), world) - len(idx)
                if pad:  # padded rows repeat sample 0; wt=0 masks them in the loss
                    idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
                    wt = np.concatenate([wt, np.zeros(pad, np.float32)])
            yield idx, wt

    def epoch_indices(self) -> Iterator[tuple]:
        """Yield this rank's (idx, wt) host arrays for one epoch: its
        contiguous slice of each global batch."""
        for idx, wt in self.global_indices():
            if self.world is not None:
                part = shard_slice(len(idx), self.rank, self.world)
                idx, wt = idx[part], wt[part]
            yield idx, wt

    def _schedule(self) -> tuple:
        """This rank's (rows, weights, offsets) for one epoch, on the
        device: every batch of ``epoch_indices()`` concatenated, batch k at
        ``offsets[k]:offsets[k + 1]`` (host ints). On a card both arrays
        go over in one asynchronous copy each from pinned memory (span
        ``upload``); the caching host allocator keeps a pinned block from
        reuse until the copy that read it has run."""
        parts = list(self.epoch_indices())
        offsets = np.cumsum([0] + [len(idx) for idx, _ in parts]).tolist()
        rows = torch.from_numpy(np.concatenate([idx for idx, _ in parts]))
        wts = torch.from_numpy(np.concatenate([wt for _, wt in parts]))
        if self.device.type != "cpu":
            with tracing.span("upload"):
                rows = rows.pin_memory().to(self.device, non_blocking=True)
                wts = wts.pin_memory().to(self.device, non_blocking=True)
        return rows, wts, offsets

    def epoch(self) -> Iterator[tuple]:
        """Yield (inputs, targets, weights) for one epoch, gathered on the
        device from the epoch's ``_schedule()``, made when the first batch
        is requested; each batch's slices and gathers (and the first's
        schedule) run in the span ``data`` of the step that takes it
        (``tracing.ahead``)."""
        for k in range(len(self)):
            with tracing.ahead("data"):
                if k == 0:
                    rows, wts, offsets = self._schedule()
                i = rows[offsets[k] : offsets[k + 1]]
                batch = self.inputs[i], self.targets[i], wts[offsets[k] : offsets[k + 1]]
            yield batch

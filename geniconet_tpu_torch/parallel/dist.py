"""Data parallelism over ``torch.distributed``.

The port's counterpart of ``geniconet_tpu/parallel/mesh.py`` and of the
collectives of the JAX ``shard_map`` step (``train/trainer.py:
_sm_value_and_grad``). The JAX package shards the global batch over a 1-D
``'data'`` mesh (shard i holds the i-th contiguous slice), keeps the
parameters replicated, ``pmean``s each BatchNorm's stacked moments over the
axis and ``psum``s the loss, the metrics and the gradients. Here a shard is
a rank: one process on one device.

* ``init`` starts the process group, from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or from the arguments; rank r runs on ``cuda:LOCAL_RANK``
  (``device_map``).
* The backend is "nccl" when every rank has a card of its own and "gloo"
  when ranks share a card or run on the CPU. The caller names it, or it
  follows from the device map. There is one backend a run: a failure raises
  and nothing falls back to the other.
* ``all_reduce_mean`` is JAX's ``pmean`` with its transpose under
  ``shard_map`` as the backward: the cotangent all-reduced and divided by
  the world size (``torch.nn.SyncBatchNorm``'s backward does the same), so
  a BatchNorm's batch-statistics gradient is the global batch's. A bare
  ``all_reduce`` would give the same loss and wrong gradients.
* ``DataParallel.sum_`` is ``psum``: one all-reduce of a list of float32
  tensors as one flat bucket (a step's gradients, loss and metrics).
* ``shard_slice`` is ``data_sharding``'s contiguous slice of rank r.

Not ported: the 2-D ``(data, spatial)`` mesh and its W-sharded XLA route
(the JAX fallback for a global batch that the device count does not
divide; here ``data/pipeline.py:Batches`` raises instead).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["DataParallel", "init", "device_map", "shard_slice", "all_reduce_mean",
           "AllReduceMean"]

# the generators of ranks 1.. start this far apart from rank 0's seed (a
# large odd number, so the folded seeds of nearby base seeds never meet)
_RANK_STREAM = 0x9E3779B1


def shard_slice(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous slice of a global batch of ``n`` rows
    (``mesh.data_sharding``: shard i holds rows i·n/world ..); raises when
    ``world`` does not divide ``n``."""
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def device_map(local_rank: int, local_world: int, device_type: str = "cuda"):
    """(device, backend) of local rank ``local_rank`` of ``local_world``:
    the CPU and gloo; or ``cuda:local_rank`` and nccl when every local rank
    has a card of its own, else card ``local_rank % cards`` shared over
    gloo (NCCL takes one rank a card)."""
    if device_type == "cpu":
        return torch.device("cpu"), "gloo"
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: 'cuda' or 'cpu'")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError("data parallelism on 'cuda': torch.cuda.is_available() is False")
    if local_world <= cards:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", local_rank % cards), "gloo"


class AllReduceMean(torch.autograd.Function):
    """JAX's ``pmean`` over the ranks: forward Σ_ranks x / world; backward
    Σ_ranks g / world, ``pmean``'s transpose under ``shard_map``."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        y = x.detach().clone()
        dist.all_reduce(y)
        return y / size

    @staticmethod
    def backward(ctx, g):
        g = g.detach().contiguous().clone()
        dist.all_reduce(g)
        return g / ctx.size, None


def all_reduce_mean(x: torch.Tensor, dp: "DataParallel") -> torch.Tensor:
    """``pmean`` of x over ``dp``'s ranks, differentiable (``AllReduceMean``)."""
    return AllReduceMean.apply(x, dp.world)


@dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel run over the default process group: its
    rank, the world size, the backend and the device it runs on. Made by
    ``init``; the ``Trainer``, the models' BatchNorms and ``Batches`` take
    it as JAX's modules take the mesh's axis name."""

    rank: int
    world: int
    backend: str
    device: torch.device

    def __str__(self):
        return f"rank {self.rank} of {self.world} on {self.device}, backend {self.backend}"

    def sum_(self, tensors) -> None:
        """``psum`` in place: every tensor (float32) summed over the ranks,
        all in one all-reduce of one flat bucket."""
        tensors = list(tensors)
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError("DataParallel.sum_ takes float32 tensors")
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        off = 0
        for t in tensors:
            n = t.numel()
            with torch.no_grad():
                t.copy_(flat[off : off + n].view_as(t))
            off += n

    def broadcast_(self, tensors, src: int = 0) -> None:
        """Rank ``src``'s values of float32 tensors on every rank, in place,
        in one broadcast of one flat bucket."""
        tensors = list(tensors)
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.broadcast(flat, src)
        off = 0
        for t in tensors:
            n = t.numel()
            with torch.no_grad():
                t.copy_(flat[off : off + n].view_as(t))
            off += n

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-rank batch x (every rank's of the same
        shape), rank r's rows at r·B ..: an all-reduce of a zero-filled
        buffer (gloo has no all-gather of CUDA tensors), in float32 for a
        float type, so every value keeps its bits."""
        kind = torch.float32 if x.is_floating_point() else x.dtype
        b = x.shape[0]
        buf = torch.zeros((self.world * b, *x.shape[1:]), dtype=kind, device=x.device)
        buf[self.rank * b : (self.rank + 1) * b] = x.detach().to(kind)
        dist.all_reduce(buf)
        return buf.to(x.dtype)

    def fold_seed(self, seed: int) -> int:
        """The seed of this rank's generator: rank 0 keeps ``seed``, rank r
        takes a stream of its own (JAX folds the shard index into its key)."""
        return seed + self.rank * _RANK_STREAM

    def barrier(self) -> None:
        dist.barrier()


def init(backend: str | None = None, device_type: str = "cuda", rank: int | None = None,
         world: int | None = None, local_rank: int | None = None,
         local_world: int | None = None, init_method: str | None = None,
         timeout_s: float = 600.0) -> DataParallel:
    """Start the default process group and return this rank's
    ``DataParallel``. Unset arguments come from torchrun's environment
    (``init_method`` "env://": ``MASTER_ADDR``, ``MASTER_PORT``); a
    rendezvous address is e.g. ``tcp://localhost:29511``. ``backend`` None
    follows from ``device_map``; "nccl" where ranks share a card raises."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world = int(env["WORLD_SIZE"]) if world is None else world
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    local_world = (int(env.get("LOCAL_WORLD_SIZE", world)) if local_world is None
                   else local_world)
    device, mapped = device_map(local_rank, local_world, device_type)
    backend = mapped if backend is None else backend
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and mapped != "nccl":
        raise ValueError(f"backend 'nccl' needs a card for each rank; {local_world} local "
                         f"ranks on {device}: use 'gloo'")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return DataParallel(rank, world, backend, device)

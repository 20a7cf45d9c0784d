"""The device the port's entry points run on."""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device="cuda") -> torch.device:
    """``torch.device(device)``; raise for a CUDA device when there is no
    card, so an entry point never quietly runs on the CPU instead. The
    entry points (``Trainer``, ``AppState``, ``Batches``) default to the
    card; pass ``device="cpu"`` to run the plain versions on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return dev

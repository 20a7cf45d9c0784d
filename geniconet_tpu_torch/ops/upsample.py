"""Icosahedral upsampling s -> s+1 (edge midpoints), plain PyTorch.

Port of ``geniconet_tpu/ops/upsample.py``: old vertices carry through, new
vertices are the midpoints of row, column and anti-diagonal edges, read from
the ``ico_pad`` halo so seams and poles follow ``corner_mode``.
"""

from __future__ import annotations

import torch

from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.pad import ico_pad
from geniconet_tpu_torch.ops.phase import phase_merge, phase_upsample

__all__ = ["ico_upsample_s2s"]


def ico_upsample_s2s(x: torch.Tensor, subdivisions: int, corner_mode: str = "average") -> torch.Tensor:
    """(B, 5, h, w, C) at subdivision s -> (B, 5, 2h, 2w, C) at s+1."""
    h, w = ico.chart_shape(subdivisions)
    B, n, xh, xw, C = x.shape
    if n != 5 or xh != h or xw != w:
        raise ValueError(f"expected (B,5,{h},{w},C), got {tuple(x.shape)}")
    return phase_merge(phase_upsample(ico_pad(x, subdivisions, corner_mode)))

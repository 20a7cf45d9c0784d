"""Grid -> vertex-list conversion with pole reconstruction, and the packed
position targets of the AE loss.

Port of ``geniconet_tpu/ops/vertices.py``. ``grid_to_vertices``: flatten the
``(5·2^s, 2^(s+1))`` grid row-major, then append the north pole (mean of
the 5 chart-local ``(0, 0)`` cells) and the south pole (mean of the
chart-local ``(2^s-1, 2^(s+1)-1)`` cells).
"""

from __future__ import annotations

import torch

from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.pad import chart_mean

__all__ = ["grid_to_vertices", "pack_target_phases"]


def grid_to_vertices(x: torch.Tensor, subdivisions: int) -> torch.Tensor:
    """(B, 5h, w, C) grid -> (B, V, C) vertex signal with poles appended."""
    h, w = ico.chart_shape(subdivisions)
    B, H, W, C = x.shape
    if H != 5 * h or W != w:
        raise ValueError(f"expected (B,{5 * h},{w},C), got {tuple(x.shape)}")
    xc = x.reshape(B, 5, h, w, C)
    north = chart_mean(xc[:, :, 0, 0, :])[:, None]
    south = chart_mean(xc[:, :, h - 1, w - 1, :])[:, None]
    return torch.cat([x.reshape(B, 5 * h * w, C), north, south], dim=1)


def pack_target_phases(target: torch.Tensor, subdivisions: int):
    """(B, V, >=3) vertex targets -> the position targets in the decoder's
    phase order: ((B, 5, h/2, w/2, 12) float32 with phase p's xyz at
    [3p:3p+3], (B, 6) = [north xyz | south xyz])."""
    h, w = ico.chart_shape(subdivisions)
    B = target.shape[0]
    pos = target[..., :3].float()
    grid = pos[:, :-2].reshape(B, 5, h, w, 3)
    tpack = torch.cat([grid[:, :, p >> 1 :: 2, p & 1 :: 2, :] for p in range(4)], dim=-1)
    return tpack, pos[:, -2:].reshape(B, 6)

"""Cross-chart halo padding for the 5-chart icosahedral grid.

Port of ``geniconet_tpu/ops/pad.py``; its module docstring derives every
halo source. ``ico_pad`` builds the ``(B, 5, h+2, w+2, C)`` padded tensor
that turns the 7-tap hex conv into a masked 3×3 VALID conv.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from geniconet_tpu_torch.geometry import ico

__all__ = ["ico_pad", "padded_index_map", "chart_mean", "MASKED", "NORTH_SYNTH", "SOUTH_SYNTH"]


def chart_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean over the chart axis (dim 1, size 5): a float32 sum in chart
    order times 0.2, cast back to the input dtype. The same arithmetic as
    XLA's mean and as the kernels' pole cells, so both agree bit for bit."""
    acc = t[:, 0].float()
    for c in range(1, t.shape[1]):
        acc = acc + t[:, c].float()
    return (acc * 0.2).to(t.dtype)


def _up(x: torch.Tensor) -> torch.Tensor:
    """Chart c+1 seen from chart c."""
    return torch.roll(x, shifts=-1, dims=1)


def _dn(x: torch.Tensor) -> torch.Tensor:
    """Chart c-1 seen from chart c."""
    return torch.roll(x, shifts=1, dims=1)


def _swap(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(2, 3)


def ico_pad(x: torch.Tensor, subdivisions: int, corner_mode: str = "average") -> torch.Tensor:
    """(B, 5, h, w, C) chart-split grid -> (B, 5, h+2, w+2, C) haloed tensor."""
    h, w = ico.chart_shape(subdivisions)
    B, n_charts, xh, xw, C = x.shape
    if n_charts != 5 or xh != h or xw != w:
        raise ValueError(f"expected (B,5,{h},{w},C) grid, got {tuple(x.shape)}")
    if corner_mode not in ("average", "zeros"):
        raise ValueError(f"unknown corner_mode {corner_mode!r}")
    up, dn = _up(x), _dn(x)
    if corner_mode == "average":
        pole_n = chart_mean(x[:, :, 0, 0, :])
        pole_s = chart_mean(x[:, :, h - 1, w - 1, :])
    else:
        pole_n = x.new_zeros((B, C))
        pole_s = x.new_zeros((B, C))
    pole_n = pole_n[:, None, None, None, :].expand(B, 5, 1, 1, C)
    pole_s = pole_s[:, None, None, None, :].expand(B, 5, 1, 1, C)
    zero = x.new_zeros((B, 5, 1, 1, C))
    top = torch.cat(
        [zero, pole_n, _swap(up[:, :, 0:h, 0:1]), up[:, :, h - 1 : h, 1 : h + 1]], dim=3
    )
    bottom = torch.cat(
        [dn[:, :, 0:1, h - 1 : w], _swap(dn[:, :, 0:h, w - 1 : w]), zero], dim=3
    )
    left = _swap(dn[:, :, 0:1, 0:h])
    right = torch.cat([_swap(up[:, :, h - 1 : h, h + 1 : w]), pole_s], dim=2)
    mid = torch.cat([left, x, right], dim=3)
    return torch.cat([top, mid, bottom], dim=2)


MASKED = -1
NORTH_SYNTH = -2
SOUTH_SYNTH = -3


@functools.lru_cache(maxsize=None)
def padded_index_map(subdivisions: int) -> np.ndarray:
    """(5, h+2, w+2) int64 map: which global vertex id each padded cell holds.

    MASKED (-1) marks never-read corners, NORTH_SYNTH (-2) / SOUTH_SYNTH
    (-3) the synthesized pole cells. Derived by running the plain
    ``ico_pad`` over a tensor of vertex ids, so it mirrors ``ico_pad`` by
    construction (the JAX package spells the same map out as loops).
    """
    h, w = ico.chart_shape(subdivisions)
    ids = torch.arange(1, 5 * h * w + 1, dtype=torch.float64).reshape(1, 5, h, w, 1)
    out = ico_pad(ids, subdivisions, "zeros")[0, ..., 0].to(torch.int64).numpy() - 1
    out[:, 0, 1] = NORTH_SYNTH
    out[:, h, w + 1] = SOUTH_SYNTH
    return out

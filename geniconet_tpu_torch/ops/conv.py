"""Hexagonal icosahedral convolution (scalar-to-scalar), plain PyTorch.

Port of ``geniconet_tpu/ops/conv.py``. After ``ico_pad`` the 7-tap hex
stencil is a VALID 3×3 convolution whose ``(-1,-1)`` and ``(+1,+1)`` corner
taps are masked; stride 2 (s -> s-1) is the same conv over ``P[:, :, 1:]``
with stride 2.

Taps are stored as the 7 active offsets ``(7, C_in, C_out)`` in the order of
``HEX_TAP_OFFSETS``. The contraction runs in float32 and rounds once to the
input dtype, as the fused kernels do (for float32 inputs this is the JAX
XLA path exactly).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.pad import ico_pad

__all__ = [
    "HEX_TAP_OFFSETS",
    "taps_to_kernel",
    "kernel_to_taps",
    "ico_conv_s2s",
    "split_charts",
    "merge_charts",
]

HEX_TAP_OFFSETS: tuple[tuple[int, int], ...] = (
    (-1, 0),
    (-1, 1),
    (0, -1),
    (0, 0),
    (0, 1),
    (1, -1),
    (1, 0),
)

_TAP_FLAT = [(di + 1) * 3 + (dj + 1) for di, dj in HEX_TAP_OFFSETS]


def taps_to_kernel(taps: torch.Tensor) -> torch.Tensor:
    """(7, Cin, Cout) tap params -> (3, 3, Cin, Cout) HWIO kernel (zeros at corners)."""
    seven, cin, cout = taps.shape
    if seven != 7:
        raise ValueError(f"expected (7, Cin, Cout) taps, got {tuple(taps.shape)}")
    full = taps.new_zeros((9, cin, cout))
    full[_TAP_FLAT] = taps
    return full.reshape(3, 3, cin, cout)


def kernel_to_taps(kernel):
    """(3, 3, Cin, Cout) HWIO kernel -> its (7, Cin, Cout) taps, the inverse of
    ``taps_to_kernel`` (the corners are dropped: callers check them). Takes a
    tensor or a numpy array and returns the same kind."""
    return kernel.reshape(9, *kernel.shape[2:])[_TAP_FLAT]


def split_charts(x: torch.Tensor, subdivisions: int) -> torch.Tensor:
    """Public grid (B, 5h, w, C) -> chart-split (B, 5, h, w, C)."""
    h, w = ico.chart_shape(subdivisions)
    B, H, W, C = x.shape
    if H != 5 * h or W != w:
        raise ValueError(f"expected (B,{5 * h},{w},C), got {tuple(x.shape)}")
    return x.reshape(B, 5, h, w, C)


def merge_charts(x: torch.Tensor) -> torch.Tensor:
    """Chart-split (B, 5, h, w, C) -> public grid (B, 5h, w, C)."""
    B, n, h, w, C = x.shape
    return x.reshape(B, n * h, w, C)


def ico_conv_s2s(
    x: torch.Tensor,
    taps: torch.Tensor,
    bias: torch.Tensor | None,
    subdivisions: int,
    stride: int = 1,
    corner_mode: str = "average",
) -> torch.Tensor:
    """Hex conv over the chart-split grid: (B, 5, h, w, Cin) -> (B, 5, h/stride, w/stride, Cout)."""
    padded = ico_pad(x, subdivisions, corner_mode)
    if stride == 2:
        padded = padded[:, :, 1:]
    elif stride != 1:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    B, n, hp, wp, cin = padded.shape
    flat = padded.reshape(B * n, hp, wp, cin).permute(0, 3, 1, 2).float()
    out = F.conv2d(
        flat,
        taps_to_kernel(taps.float()).permute(3, 2, 0, 1),  # HWIO -> OIHW
        None if bias is None else bias.float(),
        stride=stride,
    ).permute(0, 2, 3, 1)
    return out.reshape(B, n, *out.shape[1:]).to(x.dtype)

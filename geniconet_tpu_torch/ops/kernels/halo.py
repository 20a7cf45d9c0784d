"""Int32 gather tables that resolve every halo read of the hex-conv kernels.

Each table is built by running the plain ``phase_pad`` / ``ico_pad`` over a
tensor of source ids, so it agrees with the plain ops by construction;
``device_table`` builds it once per (kind, grid shape, corner_mode, device).
An entry is a source cell index (>= 0) into one sample's source space, or
one of the codes below. The kernels read a pole code as the 5-chart mean of
the pole cells (fp32 sum times 0.2, cast to the activation dtype), which is
how the plain ops build the pole too.
"""

from __future__ import annotations

import numpy as np
import torch

from geniconet_tpu_torch.ops.conv import HEX_TAP_OFFSETS
from geniconet_tpu_torch.ops.pad import ico_pad
from geniconet_tpu_torch.ops.phase import phase_pad, tap_table

__all__ = [
    "ZERO", "NORTH", "SOUTH", "NONE",
    "phase_conv_table", "std_conv_table", "upsample_table", "device_table",
]

# codes shared with csrc/common.cuh
ZERO = -1   # masked halo corner, or a pole under corner_mode='zeros'
NORTH = -2  # north pole: mean over charts of the (0, 0) cell of phase ee / of x
SOUTH = -3  # south pole: mean over charts of the (h-1, w-1) cell of phase oq / of x
NONE = -4   # upsample_table: the cell has no second operand (an old vertex)


def _check_mode(corner_mode):
    if corner_mode not in ("average", "zeros"):
        raise ValueError(f"unknown corner_mode {corner_mode!r}")


def _ids(n: int, h: int, w: int, first: int = 0) -> torch.Tensor:
    """(1, n, h, w, 1) float64 ids first+1 .. first+n·h·w (0 is left for ZERO)."""
    ids = torch.arange(first + 1, first + n * h * w + 1, dtype=torch.float64)
    return ids.reshape(1, n, h, w, 1)


def phase_conv_table(h: int, w: int, corner_mode: str) -> np.ndarray:
    """(4, 7, 5·h·w) int32: for output phase p, tap t and output cell
    (chart, i, j), the source cell ``p_in·5hw + chart·hw + i'·w + j'`` of the
    four (h, w) input phases, or a code."""
    _check_mode(corner_mode)
    n = 5 * h * w
    padded = phase_pad(tuple(_ids(5, h, w, p * n) for p in range(4)), "zeros")
    codes = [p[0, ..., 0].to(torch.int64).numpy() - 1 for p in padded]
    if corner_mode == "average":
        codes[2][:, 0, 0] = NORTH   # oo top-left cell
        codes[2][:, h, w] = SOUTH   # oo bottom-right cell
    table = np.empty((4, 7, 5, h, w), np.int32)
    for p_out in range(4):
        for t, (p_in, rs, cs) in enumerate(tap_table(p_out)):
            table[p_out, t] = codes[p_in][:, rs : rs + h, cs : cs + w]
    return table.reshape(4, 7, n)


def _ico_pad_codes(h: int, w: int, corner_mode: str) -> np.ndarray:
    """(5, h+2, w+2) codes of the ``ico_pad`` halo over one (5, h, w) grid."""
    s = h.bit_length() - 1
    P = ico_pad(_ids(5, h, w), s, "zeros")[0, ..., 0].to(torch.int64).numpy() - 1
    if corner_mode == "average":
        P[:, 0, 1] = NORTH
        P[:, h, w + 1] = SOUTH
    return P


def std_conv_table(h: int, w: int, corner_mode: str) -> np.ndarray:
    """(7, 5·h·w) int32: for tap t and output cell (chart, i, j) of the
    stride-1 standard-layout conv, the source cell ``chart·hw + i'·w + j'``
    of the (5, h, w) input grid, or a code."""
    _check_mode(corner_mode)
    P = _ico_pad_codes(h, w, corner_mode)
    table = np.empty((7, 5, h, w), np.int32)
    for t, (di, dj) in enumerate(HEX_TAP_OFFSETS):
        table[t] = P[:, 1 + di : 1 + di + h, 1 + dj : 1 + dj + w]
    return table.reshape(7, 5 * h * w)


def upsample_table(h: int, w: int, corner_mode: str) -> np.ndarray:
    """(4·5·h·w, 2) int32: the two level-s cells (in ``std_conv_table``'s
    source space, or a code) whose midpoint is each cell of the four
    upsampled phases (``ops/phase.py:phase_upsample``); the second is NONE
    for the old vertices (phase oo)."""
    _check_mode(corner_mode)
    P = _ico_pad_codes(h, w, corner_mode)
    mid = P[:, 1 : h + 1, 1 : w + 1]
    none = np.full_like(mid, NONE)
    pairs = [
        (P[:, 0:h, 1 : w + 1], mid),      # ee: row-edge midpoints
        (mid, P[:, 0:h, 2 : w + 2]),      # eq: anti-diagonal midpoints
        (mid, none),                      # oo: old vertices
        (mid, P[:, 1 : h + 1, 2 : w + 2]),  # oq: column-edge midpoints
    ]
    table = np.stack([np.stack([a, b], axis=-1) for a, b in pairs])
    return table.reshape(4 * 5 * h * w, 2).astype(np.int32)


_DEVICE_TABLES: dict = {}


def device_table(kind: str, h: int, w: int, corner_mode: str, device) -> torch.Tensor:
    """The named table as a contiguous int32 tensor on ``device``, built once
    per (kind, h, w, corner_mode, device) and kept for the process."""
    key = (kind, h, w, corner_mode, str(torch.device(device)))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        build = {"phase": phase_conv_table, "std": std_conv_table, "up": upsample_table}[kind]
        t = torch.from_numpy(build(h, w, corner_mode)).to(device).contiguous()
        _DEVICE_TABLES[key] = t
    return t

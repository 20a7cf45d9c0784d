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
    "phase_dx_table", "up_dx_table", "std_dx_table", "device_dx_table",
    "up_adjoint_table", "phase_dx_codes", "std_dx_codes", "device_dx_codes",
]

# codes shared with csrc/common.cuh
ZERO = -1   # masked halo corner, or a pole under corner_mode='zeros'
NORTH = -2  # north pole: mean over charts of the (0, 0) cell of phase ee / of x
SOUTH = -3  # south pole: mean over charts of the (h-1, w-1) cell of phase oq / of x
NONE = -4   # upsample_table: the cell has no second operand (an old vertex)


def _check_mode(corner_mode):
    if corner_mode not in ("average", "zeros"):
        raise ValueError(f"unknown corner_mode {corner_mode!r}")


def _check_stride(stride):
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


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


def std_conv_table(h: int, w: int, corner_mode: str, stride: int = 1) -> np.ndarray:
    """(7, 5·h'·w') int32: for tap t and output cell (chart, i, j) of the
    standard-layout conv over a (5, h, w) input grid, the source cell
    ``chart·hw + i'·w + j'`` of that grid, or a code. Stride 1: h' = h,
    w' = w, the windows ``P[1+di : 1+di+h, 1+dj : 1+dj+w]`` of the padded
    grid; stride 2: h' = h/2, w' = w/2, the centres ``P[2r+2, 2q+1]``, rows
    ``(2+di)::2`` and columns ``(1+dj)::2`` (the Pallas ``_tap_slice``)."""
    _check_mode(corner_mode)
    _check_stride(stride)
    P = _ico_pad_codes(h, w, corner_mode)
    ho, wo = h // stride, w // stride
    table = np.empty((7, 5, ho, wo), np.int32)
    for t, (di, dj) in enumerate(HEX_TAP_OFFSETS):
        if stride == 1:
            table[t] = P[:, 1 + di : 1 + di + h, 1 + dj : 1 + dj + w]
        else:
            table[t] = P[:, 2 + di : 2 + di + h : 2, 1 + dj : 1 + dj + w : 2]
    return table.reshape(7, 5 * ho * wo)


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


# --------------------------------------------------------------------------
# transposed tables for the dx kernels
# --------------------------------------------------------------------------
#
# A forward table says which source cell each (output phase, tap, output
# cell) reads. The dx kernels need the other direction: for each source cell
# and tap, every output cell that reads it and with which weight (1 for a
# plain read, 0.2 for each of the 5 cells of a pole mean, 0.5 for each end of
# an upsampled midpoint, and products of these where the up conv composes
# three pads). A transposed table is CSR: ``offsets`` (7·R + 1,) int32 into
# ``cells`` (int32, ``slot·M + m`` with slot the position of the output phase
# in ``out_phases`` and M = 5·h·w) and ``weights`` (float32), row ``t·R + r``
# for tap t and source cell r. dx is then a deterministic gather-GEMM.


def _poles_expand(dst, src, w, north_cells, south_cells):
    """Entries (dst, src code, w) -> entries on cells: a code >= 0 stays, ZERO
    drops, a pole code becomes 5 entries of weight w·0.2 on its chart cells."""
    keep = src >= 0
    parts = [(dst[keep], src[keep], w[keep])]
    for code, cells in ((NORTH, north_cells), (SOUTH, south_cells)):
        sel = src == code
        for cell in cells:
            parts.append((dst[sel], np.full(int(sel.sum()), cell, np.int64), w[sel] * 0.2))
    return tuple(np.concatenate(p) for p in zip(*parts))


def _conv_entries(h: int, w: int, corner_mode: str, out_phases):
    """(tap·n_cells + cell, phase-space source code, weight 1) for every
    read of the selected output phases of the phase conv."""
    table = phase_conv_table(h, w, corner_mode).astype(np.int64)
    n = 5 * h * w
    dst, src = [], []
    for slot, p in enumerate(out_phases):
        for t in range(7):
            dst.append(t * len(out_phases) * n + slot * n + np.arange(n))
            src.append(table[p, t])
    dst, src = np.concatenate(dst), np.concatenate(src)
    return dst, src, np.ones(len(dst))


def _to_csr(dst, src, w, n_src: int, n_dst_per_tap: int, n_taps: int = 7):
    """Coalesce (tap·n_dst + d, source r, w) into the CSR rows t·R + r."""
    t, d = np.divmod(dst, n_dst_per_tap)
    key = (t * n_src + src) * n_dst_per_tap + d
    uniq, inv = np.unique(key, return_inverse=True)
    weights = np.zeros(len(uniq))
    np.add.at(weights, inv, w)
    row, cells = np.divmod(uniq, n_dst_per_tap)
    offsets = np.zeros(n_taps * n_src + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n_taps * n_src), out=offsets[1:])
    return offsets.astype(np.int32), cells.astype(np.int32), weights.astype(np.float32)


def phase_dx_table(h: int, w: int, corner_mode: str, out_phases=(0, 1, 2, 3)):
    """Transposed ``phase_conv_table`` for these output phases: CSR over the
    R = 4·5·h·w cells of the four input phases (source ``p·5hw + cell``).
    Stride 2 (``out_phases=(2,)``) reads only output phase 2, so its
    transpose is another table."""
    _check_mode(corner_mode)
    n, hw = 5 * h * w, h * w
    dst, src, wt = _conv_entries(h, w, corner_mode, tuple(out_phases))
    north = [c * hw for c in range(5)]                  # phase ee, cell (0, 0)
    south = [3 * n + c * hw + hw - 1 for c in range(5)]  # phase oq, last cell
    dst, src, wt = _poles_expand(dst, src, wt, north, south)
    return _to_csr(dst, src, wt, 4 * n, len(out_phases) * n)


def up_dx_table(h: int, w: int, corner_mode: str):
    """Transposed composite of the up conv's three pads: CSR over the
    R = 5·h·w cells of the level-s input. A conv read of an upsampled cell
    (or of a level-(s+1) pole, the mean of 5 of them) expands to its one or
    two level-s ``ico_pad`` cells (weight 1, or 0.5 each for a midpoint),
    each of which is an input cell, a zero or a level-s pole (0.2 on each of
    5 cells); equal (tap, source, output cell) entries are summed."""
    _check_mode(corner_mode)
    n, hw = 5 * h * w, h * w
    dst, src, wt = _conv_entries(h, w, corner_mode, (0, 1, 2, 3))
    # level-(s+1) poles: phase ee cell 0 / phase oq last cell of the new phases
    dst, u, wt = _poles_expand(dst, src, wt, [c * hw for c in range(5)],
                               [3 * n + c * hw + hw - 1 for c in range(5)])
    pairs = upsample_table(h, w, corner_mode).astype(np.int64)
    a, b = pairs[u, 0], pairs[u, 1]
    single = b == NONE
    dst = np.concatenate([dst, dst[~single]])
    src = np.concatenate([a, b[~single]])
    wt = np.concatenate([np.where(single, wt, 0.5 * wt), 0.5 * wt[~single]])
    # level-s poles of the ico_pad halo: cell (0, 0) / cell (h-1, w-1) of each chart
    dst, src, wt = _poles_expand(dst, src, wt, [c * hw for c in range(5)],
                                 [c * hw + hw - 1 for c in range(5)])
    return _to_csr(dst, src, wt, n, 4 * n)


def std_dx_table(h: int, w: int, corner_mode: str, stride: int = 1):
    """Transposed ``std_conv_table``: CSR over the R = 5·h·w cells of the
    standard-layout input, ``cells`` the output cells (5·h'·w' of them, h' =
    h/stride) that read each. Each (tap, output cell) read of a cell, a zero
    or a pole mean (0.2 on cell (0, 0) / (h-1, w-1) of each chart) becomes
    entries on the cells it reads."""
    _check_mode(corner_mode)
    n, hw = 5 * h * w, h * w
    table = std_conv_table(h, w, corner_mode, stride).astype(np.int64)
    n_out = table.shape[1]
    dst = (np.arange(7)[:, None] * n_out + np.arange(n_out)[None, :]).ravel()
    dst, src, wt = _poles_expand(dst, table.ravel(), np.ones(7 * n_out),
                                 [c * hw for c in range(5)],
                                 [c * hw + hw - 1 for c in range(5)])
    return _to_csr(dst, src, wt, n, n_out)


def up_adjoint_table(h: int, w: int, corner_mode: str):
    """Transposed ``upsample_table`` with the level-s pad: CSR over the
    R = 5·h·w level-s cells, ``offsets`` (R + 1,), ``cells`` the upsampled
    cells ``p·5hw + m`` of the four level-(s+1) phases that read the cell
    and ``weights`` how much (1 for an old vertex, 0.5 for each end of a
    midpoint, times 0.2 where the end is a level-s pole). The adjoint of
    ``phase_upsample(ico_pad(x))``: up_dual_conv_dx's bf16 path runs it
    after its GEMM has produced the cotangent of the four upsampled phases."""
    _check_mode(corner_mode)
    n, hw = 5 * h * w, h * w
    pairs = upsample_table(h, w, corner_mode).astype(np.int64)
    a, b = pairs[:, 0], pairs[:, 1]
    single = b == NONE
    u = np.arange(4 * n)
    dst = np.concatenate([u, u[~single]])
    src = np.concatenate([a, b[~single]])
    wt = np.concatenate([np.where(single, 1.0, 0.5), np.full(int((~single).sum()), 0.5)])
    dst, src, wt = _poles_expand(dst, src, wt, [c * hw for c in range(5)],
                                 [c * hw + hw - 1 for c in range(5)])
    return _to_csr(dst, src, wt, n, 4 * n, n_taps=1)


def _rows_of(offsets, weights):
    """Per CSR row: its entry count and whether it is one entry of weight 1."""
    count = np.diff(offsets.astype(np.int64))
    first = np.minimum(offsets[:-1], max(len(weights) - 1, 0))
    one = (count == 1) & (weights[first] == 1.0) if len(weights) else count < 0
    return count, one


def _dx_codes(offsets, cells, weights, n_in: int, M: int, n_rows: int):
    """A transposed table's CSR (rows ``t·R + r`` over R = n_in·M source
    rows) as the bf16 dx GEMM reads it: (codes (n_in, 7, M) int32, combined
    rows, tap masks). A row that is one entry of weight 1 names that
    cotangent row, an empty row ZERO, any other row ``n_rows + j``, combined
    row j (the rows after a sample's n_rows cotangent rows). ``comb`` =
    (offsets (J + 1,), cells, weights) lists each combined row's entries in
    the CSR's order. ``mask`` (n_in·M / 128,) uint8 holds, per 128-row tile
    of one sample's n_in·M GEMM rows, bit t for a tap whose codes in the
    tile are not all ZERO (the GEMM skips the others), or None where n_in·M
    is not a multiple of 128."""
    count, one = _rows_of(offsets, weights)
    comb_rows = np.nonzero((count > 0) & ~one)[0]
    codes = np.full(7 * n_in * M, ZERO, np.int64)  # CSR row order: t·R + r
    codes[one] = cells[offsets[:-1][one]]
    codes[comb_rows] = n_rows + np.arange(len(comb_rows))
    lo, hi = offsets[comb_rows].astype(np.int64), offsets[comb_rows + 1].astype(np.int64)
    sel = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)]) if len(lo) else \
        np.zeros(0, np.int64)
    comb_offsets = np.zeros(len(comb_rows) + 1, np.int64)
    np.cumsum(hi - lo, out=comb_offsets[1:])
    codes = codes.reshape(7, n_in, M).transpose(1, 0, 2)  # (p, t, m)
    mask = None
    if (n_in * M) % 128 == 0:
        live = (codes != ZERO).transpose(1, 0, 2).reshape(7, n_in * M // 128, 128).any(-1)
        mask = (live * (1 << np.arange(7))[:, None]).sum(0).astype(np.uint8)
    comb = (comb_offsets.astype(np.int32), cells[sel].astype(np.int32),
            weights[sel].astype(np.float32))
    return np.ascontiguousarray(codes, dtype=np.int32), comb, mask


def phase_dx_codes(h: int, w: int, corner_mode: str, out_phases=(0, 1, 2, 3)):
    """The bf16 dx GEMM's view of ``phase_dx_table``: (codes, combined rows,
    tap masks), ``_dx_codes`` over the 4 input phases.

    The GEMM reads, for input phase p, tap t and cell m, ONE row of the
    written cotangent operand (per sample its n_out·5hw cotangent rows
    ``slot·M + m``, then its combined rows; a zero row after the last
    sample). ``codes`` (4, 7, M) names it: the cotangent row q where the
    transposed row t·R + p·M + m is one entry of weight 1, ZERO where it is
    empty, and n_out·M + j where it is anything else, combined row j (the
    stride-1 seams, weights (1, 1), and 10 pole rows, five 0.2 and two 1):
    the operand pass writes its weighted sum in float32, rounded to bf16.
    ``mask`` has a byte per 128-row tile of one sample's 4·M GEMM rows."""
    n = 5 * h * w
    return _dx_codes(*phase_dx_table(h, w, corner_mode, out_phases), 4, n, len(out_phases) * n)


def std_dx_codes(h: int, w: int, corner_mode: str, stride: int = 1):
    """The bf16 dx GEMM's view of ``std_dx_table``, ``_dx_codes`` over the
    one input grid of M = 5·h·w cells: codes (1, 7, M) naming, for tap t and
    input cell m, a row of the written cotangent operand (per sample its
    5·h'·w' cotangent rows, h' = h/stride, then its combined rows: the chart
    seams and the 10 pole rows), the combined rows, and a mask byte per
    128-row tile of one sample's M GEMM rows (None where M is not a multiple
    of 128: an input at level 2)."""
    n = 5 * h * w
    return _dx_codes(*std_dx_table(h, w, corner_mode, stride), 1, n, n // stride**2)


_DEVICE_TABLES: dict = {}


def device_table(kind: str, h: int, w: int, corner_mode: str, device,
                 stride: int = 1) -> torch.Tensor:
    """The named table as a contiguous int32 tensor on ``device``, built once
    per (kind, h, w, corner_mode, stride, device) and kept for the process;
    ``stride`` is the standard conv's (``"std"``), over a (5, h, w) input."""
    key = (kind, h, w, corner_mode, stride, str(torch.device(device)))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        if kind == "std":
            arr = std_conv_table(h, w, corner_mode, stride)
        else:
            arr = {"phase": phase_conv_table, "up": upsample_table}[kind](h, w, corner_mode)
        t = torch.from_numpy(arr).to(device).contiguous()
        _DEVICE_TABLES[key] = t
    return t


def device_dx_table(kind: str, h: int, w: int, corner_mode: str, device, out_phases=None,
                    stride: int = 1):
    """A transposed table (``"phase"`` with its out_phases, ``"up"``, ``"std"``
    with its stride, or ``"up_adjoint"``) as (offsets, cells, weights)
    tensors on ``device``, built once and kept."""
    out_phases = None if out_phases is None else tuple(out_phases)
    key = ("dx", kind, h, w, corner_mode, out_phases, stride, str(torch.device(device)))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        if kind == "phase":
            arrs = phase_dx_table(h, w, corner_mode, out_phases)
        elif kind == "std":
            arrs = std_dx_table(h, w, corner_mode, stride)
        else:
            arrs = {"up": up_dx_table, "up_adjoint": up_adjoint_table}[kind](h, w, corner_mode)
        t = tuple(torch.from_numpy(a).to(device).contiguous() for a in arrs)
        _DEVICE_TABLES[key] = t
    return t


def device_dx_codes(h: int, w: int, corner_mode: str, device, out_phases=(0, 1, 2, 3),
                    stride: int = 1):
    """``phase_dx_codes`` for these output phases, or ``std_dx_codes`` at
    ``stride`` for ``out_phases=None`` (the standard conv), on ``device``,
    built once and kept: (codes, comb offsets, comb cells, comb weights,
    mask or None, combined rows a sample)."""
    out_phases = None if out_phases is None else tuple(out_phases)
    key = ("codes", h, w, corner_mode, out_phases, stride, str(torch.device(device)))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        codes, comb, mask = (std_dx_codes(h, w, corner_mode, stride) if out_phases is None
                             else phase_dx_codes(h, w, corner_mode, out_phases))
        t = (*(torch.from_numpy(a).to(device).contiguous() for a in (codes, *comb)),
             None if mask is None else torch.from_numpy(mask).to(device), len(comb[0]) - 1)
        _DEVICE_TABLES[key] = t
    return t

"""Phase-domain (parity-decomposed) form of the icosahedral grid and hex conv.

Port of ``geniconet_tpu/ops/phase.py``; its module docstring derives the
phase halo table. A level-s grid ``U`` is carried as its four parity phases
``phi[pr, pq][i, j] = U[2i + pr, 2j + pq]`` (phase index ``p = 2·pr + pq``).
A stride-1 hex conv maps 4 phases to 4 phases through one tap table; the
stride-2 conv (s -> s-1) is output phase 2 = (1, 0) of the same table and is
already in standard level-(s-1) layout; the upsample s -> s+1 emits the four
phases of level s+1 directly from the padded level-s tensor.

These plain functions are the reference the phase kernels
(``ops/kernels/phase_kernel.py``) are held against. ``phase_conv``
accumulates in float32 and rounds once to the input dtype, as the kernels
do (for float32 inputs this is the JAX XLA composition exactly).
"""

from __future__ import annotations

import torch

from geniconet_tpu_torch.ops.conv import HEX_TAP_OFFSETS
from geniconet_tpu_torch.ops.pad import _dn, _swap, _up, chart_mean

__all__ = [
    "phase_split",
    "phase_merge",
    "phase_pad",
    "phase_conv",
    "phase_upsample",
    "tap_table",
]


def tap_table(out_phase: int):
    """For output phase p' and each hex tap t: (input phase p, row/col slice
    starts (rs, cs) into the (h+1, w+1) padded phase array)."""
    pr_, pq_ = out_phase >> 1, out_phase & 1
    out = []
    for di, dj in HEX_TAP_OFFSETS:
        pr, pq = (pr_ + di) % 2, (pq_ + dj) % 2
        oi, oj = (pr_ + di) // 2, (pq_ + dj) // 2
        out.append((2 * pr + pq, oi + pr, oj + pq))
    return tuple(out)


def phase_split(x: torch.Tensor):
    """(B, 5, H, W, C) level-s grid -> 4 phase tensors (B, 5, H/2, W/2, C)."""
    return tuple(x[:, :, p >> 1 :: 2, p & 1 :: 2, :] for p in range(4))


def phase_merge(phases) -> torch.Tensor:
    """Inverse of phase_split (the interleave)."""
    ee, eq, oo, oq = phases
    B, n, h, w, C = ee.shape
    even_rows = torch.stack([ee, eq], dim=4).reshape(B, n, h, 2 * w, C)
    odd_rows = torch.stack([oo, oq], dim=4).reshape(B, n, h, 2 * w, C)
    return torch.stack([even_rows, odd_rows], dim=3).reshape(B, n, 2 * h, 2 * w, C)


def phase_pad(phases, corner_mode: str = "average"):
    """Phase tensors (each (B, 5, h, w, C)) -> padded (B, 5, h+1, w+1, C).

    Array index [a, b] of padded phase (pr, pq) = phase coordinate
    (a - pr, b - pq). Masked cells (never read by the 7 hex taps) hold zeros.
    """
    ee, eq, oo, oq = phases
    B, n, h, w, C = ee.shape
    if w != 2 * h:
        raise ValueError(f"phase tensors must be (B,5,h,2h,C), got {tuple(ee.shape)}")
    if corner_mode == "average":
        pole_n = chart_mean(ee[:, :, 0, 0, :])
        pole_s = chart_mean(oq[:, :, h - 1, w - 1, :])
    elif corner_mode == "zeros":
        pole_n = ee.new_zeros((B, C))
        pole_s = ee.new_zeros((B, C))
    else:
        raise ValueError(f"unknown corner_mode {corner_mode!r}")
    pole_n = pole_n[:, None, None, None, :].expand(B, n, 1, 1, C)
    pole_s = pole_s[:, None, None, None, :].expand(B, n, 1, 1, C)
    zc = ee.new_zeros((B, n, 1, 1, C))

    ee_right = _swap(_up(oq)[:, :, h - 1 : h, h:w])
    ee_bot = torch.cat(
        [_dn(ee)[:, :, 0:1, h:w], _swap(_dn(eq)[:, :, 0:h, w - 1 : w]), zc], dim=3
    )
    ee_p = torch.cat([torch.cat([ee, ee_right], dim=3), ee_bot], dim=2)

    eq_left = _swap(_dn(ee)[:, :, 0:1, 0:h])
    eq_bot = torch.cat(
        [_dn(eq)[:, :, 0:1, h - 1 : w], _swap(_dn(oq)[:, :, 0:h, w - 1 : w])], dim=3
    )
    eq_p = torch.cat([torch.cat([eq_left, eq], dim=3), eq_bot], dim=2)

    oo_top = torch.cat(
        [pole_n, _swap(_up(oo)[:, :, 0:h, 0:1]), _up(oo)[:, :, h - 1 : h, 1 : h + 1]], dim=3
    )
    oo_right = torch.cat([_swap(_up(oo)[:, :, h - 1 : h, h + 1 : w]), pole_s], dim=2)
    oo_p = torch.cat([oo_top, torch.cat([oo, oo_right], dim=3)], dim=2)

    oq_top = torch.cat(
        [zc, _swap(_up(ee)[:, :, 0:h, 0:1]), _up(oq)[:, :, h - 1 : h, 0:h]], dim=3
    )
    oq_p = torch.cat(
        [oq_top, torch.cat([_swap(_dn(eq)[:, :, 0:1, 0:h]), oq], dim=3)], dim=2
    )
    return ee_p, eq_p, oo_p, oq_p


def phase_conv(phases, taps, bias, corner_mode: str = "average", out_phases=(0, 1, 2, 3)):
    """Hex conv in phase form.

    phases: 4 tensors (B, 5, h, w, C_in), the phase decomposition of a
    level-s grid. taps: (7, C_in, C_out); bias: (C_out,) or None.
    out_phases: (0, 1, 2, 3) = the stride-1 conv at level s (merge with
    ``phase_merge``); (2,) = the stride-2 conv s -> s-1, standard layout.
    Returns one (B, 5, h, w, C_out) tensor per requested output phase.
    """
    padded = [p.float() for p in phase_pad(phases, corner_mode)]
    h, w = phases[0].shape[2], phases[0].shape[3]
    taps32 = taps.float()
    outs = []
    for p_out in out_phases:
        acc = None
        for t, (p_in, rs, cs) in enumerate(tap_table(p_out)):
            term = padded[p_in][:, :, rs : rs + h, cs : cs + w, :] @ taps32[t]
            acc = term if acc is None else acc + term
        if bias is not None:
            acc = acc + bias.float()
        outs.append(acc.to(phases[0].dtype))
    return tuple(outs)


def phase_upsample(x_padded: torch.Tensor):
    """Padded level-s tensor P (B, 5, h+2, w+2, C) -> the four phases of the
    upsampled level-(s+1) grid, each (B, 5, h, w, C). Midpoints are summed
    in the input dtype, so in bf16 the sum rounds before the halving."""
    h, w = x_padded.shape[2] - 2, x_padded.shape[3] - 2
    P = x_padded
    oo = P[:, :, 1 : h + 1, 1 : w + 1]
    ee = (P[:, :, 0:h, 1 : w + 1] + oo) * 0.5
    oq = (oo + P[:, :, 1 : h + 1, 2 : w + 2]) * 0.5
    eq = (oo + P[:, :, 0:h, 2 : w + 2]) * 0.5
    return ee, eq, oo, oq

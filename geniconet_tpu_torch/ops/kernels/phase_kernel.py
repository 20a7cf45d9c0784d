"""Phase-domain hex-conv kernels: phase conv, upsample + dual conv, pair head.

Port of the forward halves of ``geniconet_tpu/ops/pallas/phase_kernel.py``
that the serving path runs:

* ``phase_conv_fwd``     -> ``csrc/phase_conv.cu`` (``fused_phase_conv_s1``
  and ``fused_dual_s2_conv``: 4 phases in; all 4 output phases, or phase 2
  alone for stride 2; 1 or 2 tap sets; optional act prologue);
* ``up_dual_conv_fwd``   -> ``csrc/up_conv.cu`` (``fused_up_dual_conv``);
* ``pair_head_fwd``      -> ``csrc/pair_head.cu`` (``fused_pair_head``).

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain PyTorch version beside each wrapper, built from ``ops/phase.py``.
"""

from __future__ import annotations

import torch

from geniconet_tpu_torch.ops.kernels import build
from geniconet_tpu_torch.ops.kernels.build import (
    act_apply, check_act, expect, grid_level, on_cuda,
)
from geniconet_tpu_torch.ops.kernels.halo import device_table
from geniconet_tpu_torch.ops.pad import ico_pad
from geniconet_tpu_torch.ops.phase import phase_conv, phase_upsample

__all__ = [
    "phase_conv_fwd", "phase_conv_fwd_plain",
    "up_dual_conv_fwd", "up_dual_conv_fwd_plain",
    "pair_head_fwd", "pair_head_fwd_plain",
]

_OUT_PHASES = ((0, 1, 2, 3), (2,))


def _check_sets(tap_sets, cin, dt, dev, name):
    if not 1 <= len(tap_sets) <= 2:
        raise ValueError(f"{name}: takes 1 or 2 tap sets, got {len(tap_sets)}")
    cout = tap_sets[0][0].shape[-1]
    for taps, bias in tap_sets:
        expect(taps, (7, cin, cout), dt, dev, f"{name} taps")
        if bias is not None:
            expect(bias, (cout,), dt, dev, f"{name} bias")
    return cout


def _set_ptrs(tap_sets):
    ptrs = []
    for i in range(2):
        taps, bias = tap_sets[i] if i < len(tap_sets) else (None, None)
        ptrs += [build.ptr(taps), build.ptr(bias)]
    return ptrs


# --------------------------------------------------------------------------
# phase conv (fused_phase_conv_s1 / fused_dual_s2_conv)
# --------------------------------------------------------------------------


def phase_conv_fwd_plain(phases, tap_sets, corner_mode="average", out_phases=(0, 1, 2, 3),
                         act=None):
    """Plain version: act prologue, then ``ops/phase.py:phase_conv`` per set."""
    phases = tuple(act_apply(p, act) for p in phases)
    return [phase_conv(phases, taps, bias, corner_mode, out_phases) for taps, bias in tap_sets]


def phase_conv_fwd(phases, tap_sets, corner_mode: str = "average", out_phases=(0, 1, 2, 3),
                   act=None):
    """Hex conv in phase form.

    phases: 4 contiguous (B, 5, h, w, C_in) tensors, float32 or bfloat16.
    tap_sets: 1 or 2 (taps (7, C_in, C_out), bias (C_out,) or None) in the
    same dtype, all with one C_out. out_phases: (0, 1, 2, 3) for the
    stride-1 conv, (2,) for the stride-2 conv (standard level-(s-1) output).
    act: optional float32 (mul, add), each (C_in,), the relu(x·mul + add)
    prologue applied before the halo.
    Returns, per tap set, a tuple of (B, 5, h, w, C_out) output phases.
    """
    out_phases = tuple(out_phases)
    if out_phases not in _OUT_PHASES:
        raise ValueError(f"phase_conv_fwd: out_phases must be one of {_OUT_PHASES}")
    if len(phases) != 4:
        raise ValueError(f"phase_conv_fwd: takes 4 phases, got {len(phases)}")
    x0 = phases[0]
    if not on_cuda(x0, "phase_conv_fwd"):
        return phase_conv_fwd_plain(phases, tap_sets, corner_mode, out_phases, act)
    B, _, h, w, cin = x0.shape
    grid_level(h, w)
    dev, dt = x0.device, x0.dtype
    for i, p in enumerate(phases):
        expect(p, (B, 5, h, w, cin), dt, dev, f"phase_conv_fwd phase {i}")
    cout = _check_sets(tap_sets, cin, dt, dev, "phase_conv_fwd")
    check_act(act, cin, dev, "phase_conv_fwd")
    n_sets, n_out = len(tap_sets), len(out_phases)
    outs = [torch.empty((B, 5, h, w, cout), dtype=dt, device=dev)
            for _ in range(n_sets * n_out)]
    table = device_table("phase", h, w, corner_mode, dev)
    mul, add = act if act is not None else (None, None)
    out_ptrs = build.ptr_array(outs)
    with torch.cuda.device(dev):
        err = build.library().gn_phase_conv_fwd(
            *[p.data_ptr() for p in phases], build.ptr(mul), build.ptr(add),
            *_set_ptrs(tap_sets), out_ptrs, table.data_ptr(),
            B, h, w, cin, cout, n_sets, out_phases[0], n_out, build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("phase_conv_fwd", err)
    build.LAUNCHES["phase_conv_fwd"] += 1
    return [tuple(outs[i * n_out : (i + 1) * n_out]) for i in range(n_sets)]


# --------------------------------------------------------------------------
# upsample + dual conv (fused_up_dual_conv)
# --------------------------------------------------------------------------


def up_dual_conv_fwd_plain(x, tap_sets, corner_mode="average"):
    """Plain version: ``ico_pad`` at level s, the midpoint phases of level
    s+1 (``phase_upsample``), then ``phase_conv`` (all 4 phases) per set."""
    s = grid_level(x.shape[2], x.shape[3])
    phases = phase_upsample(ico_pad(x, s, corner_mode))
    return [phase_conv(phases, taps, bias, corner_mode) for taps, bias in tap_sets]


def up_dual_conv_fwd(x, tap_sets, corner_mode: str = "average"):
    """An UpBlock's upsample s -> s+1 and first convs, fused.

    x: contiguous (B, 5, h, w, C_in) level-s grid, float32 or bfloat16;
    tap_sets: 1 or 2 (taps, bias) as for ``phase_conv_fwd``.
    Returns, per tap set, the 4 level-(s+1) output phases (B, 5, h, w, C_out).
    """
    if not on_cuda(x, "up_dual_conv_fwd"):
        return up_dual_conv_fwd_plain(x, tap_sets, corner_mode)
    B, _, h, w, cin = x.shape
    grid_level(h, w)
    dev, dt = x.device, x.dtype
    expect(x, (B, 5, h, w, cin), dt, dev, "up_dual_conv_fwd x")
    cout = _check_sets(tap_sets, cin, dt, dev, "up_dual_conv_fwd")
    n_sets = len(tap_sets)
    outs = [torch.empty((B, 5, h, w, cout), dtype=dt, device=dev) for _ in range(4 * n_sets)]
    conv_table = device_table("phase", h, w, corner_mode, dev)
    up_table = device_table("up", h, w, corner_mode, dev)
    out_ptrs = build.ptr_array(outs)
    with torch.cuda.device(dev):
        err = build.library().gn_up_dual_conv_fwd(
            x.data_ptr(), *_set_ptrs(tap_sets), out_ptrs, conv_table.data_ptr(),
            up_table.data_ptr(), B, h, w, cin, cout, n_sets, build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("up_dual_conv_fwd", err)
    build.LAUNCHES["up_dual_conv_fwd"] += 1
    return [tuple(outs[i * 4 : (i + 1) * 4]) for i in range(n_sets)]


# --------------------------------------------------------------------------
# pair head (fused_pair_head)
# --------------------------------------------------------------------------


def pair_head_fwd_plain(b0, y10, affines, W, bias):
    """Plain version: the residual join in float32, cast to the activation
    dtype; the 1×1 head with float32 sums plus bias, cast to the activation
    dtype; float32 tanh."""
    mul1, add1, mul2, add2 = affines
    dt = b0[0].dtype
    outs = []
    for a, b in zip(b0, y10):
        t = torch.clamp_min(a.float() * mul1 + add1 + b.float() * mul2 + add2, 0.0).to(dt)
        z = t.float() @ W.float() + bias.float()
        outs.append(torch.tanh(z.to(dt).float()))
    return tuple(outs)


def pair_head_fwd(b0, y10, affines, W, bias):
    """Last-UpBlock tail + 1×1 head + tanh, fused.

    b0, y10: 4-tuples of contiguous (B, 5, h, w, C) phases (float32 or
    bfloat16); affines: float32 (mul1, add1, mul2, add2), each (C,), the
    pending bn01 / bn10 applies; W (C, F) and bias (F,) in the phases' dtype.
    Returns the 4 output phases (B, 5, h, w, F) in float32.
    """
    x0 = b0[0]
    if not on_cuda(x0, "pair_head_fwd"):
        return pair_head_fwd_plain(b0, y10, affines, W, bias)
    B, _, h, w, cin = x0.shape
    F = W.shape[-1]
    dev, dt = x0.device, x0.dtype
    if len(b0) != 4 or len(y10) != 4:
        raise ValueError("pair_head_fwd: takes 4 + 4 phases")
    for i, p in enumerate((*b0, *y10)):
        expect(p, (B, 5, h, w, cin), dt, dev, f"pair_head_fwd input {i}")
    for a in affines:
        expect(a, (cin,), torch.float32, dev, "pair_head_fwd affine")
    expect(W, (cin, F), dt, dev, "pair_head_fwd W")
    expect(bias, (F,), dt, dev, "pair_head_fwd bias")
    outs = [torch.empty((B, 5, h, w, F), dtype=torch.float32, device=dev) for _ in range(4)]
    in_ptrs, out_ptrs = build.ptr_array((*b0, *y10)), build.ptr_array(outs)
    with torch.cuda.device(dev):
        err = build.library().gn_pair_head_fwd(
            in_ptrs, *[a.data_ptr() for a in affines], W.data_ptr(), bias.data_ptr(), out_ptrs,
            B, h, w, cin, F, build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("pair_head_fwd", err)
    build.LAUNCHES["pair_head_fwd"] += 1
    return tuple(outs)

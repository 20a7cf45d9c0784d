"""Standard-layout hex conv with the BN-apply + ReLU prologue (stride 1 or
2): forward with optional BatchNorm stats, and its backward kernels.

Port of ``geniconet_tpu/ops/pallas/conv_kernel.py``:

* ``ico_conv_s2s_fwd``   -> ``csrc/phase_conv.cu`` (``_pallas_forward``, with
  ``with_stats`` the (2, C_out) float32 ``[Σy, Σy²]`` of the downcast output;
  the phase conv's launcher over one source and ``halo.std_conv_table``: in
  bf16 the act-applied operand written once, then the tensor-core GEMM with
  the stats epilogue, ``csrc/mma_conv_fwd.cuh``; in float32 the SIMT GEMM);
* ``ico_conv_s2s_dx``    -> ``csrc/ico_conv_bwd.cu`` (``_pallas_dx``: conv and
  halo transposes, act adjoint with d_mul/d_add, optional Σg_eff); in bf16
  the folded cotangent written once with its combined rows, then the
  tensor-core GEMM over ``halo.std_dx_codes``' rows with the act adjoint in
  its epilogue (``csrc/mma_conv_fwd.cuh``, ``phase_kernel.dx_scratch`` with
  one input grid), in float32 the SIMT gather-GEMM over ``std_dx_table``;
* ``ico_conv_s2s_dtaps`` -> ``csrc/ico_conv_bwd.cu`` (``_pallas_dtaps``, rounded
  to the activation dtype as the Pallas wrapper does); in bf16 it writes the
  act-applied operand once (``phase_kernel.grid_operand`` of the one grid)
  and runs the tensor-core GEMM over its gathered rows
  (``csrc/mma_dtaps.cuh``), in float32 the SIMT GEMM;
* ``ico_conv_s2s_bwd``   -> ``csrc/ico_conv_bwd.cu`` (``_std_bwd``: the
  merged one-pass backward, dx with the act adjoint, dtaps, Σg_eff and
  d_mul/d_add); in bf16 the two passes of the split pair over one folded
  cotangent and one launch of both tensor-core GEMMs
  (``csrc/mma_merged_bwd.cuh``), bit-equal to ``ico_conv_s2s_dx`` +
  ``ico_conv_s2s_dtaps``; in float32 one launch of the SIMT tiles of both.

Stride 2 (s -> s-1, the Pallas ``_tap_slice`` centres ``P[2r+2, 2q+1]``)
runs the same kernels over the stride-2 tables (``halo.std_conv_table``,
``std_dx_table``, ``std_dx_codes`` with ``stride=2``): the input grid is
(h, w), the output (h/2, w/2); the GEMMs are the stride-1 ones.

``y`` and ``gs`` (the forward output and the cotangent of its stats) switch
on the in-kernel fold g_eff = g + gs0 + 2·gs1·y, rounded to the activation
dtype. The custom VJP built from them, ``fused_ico_conv_s2s``, is in
``ops/kernels/fused.py``. A CUDA tensor goes to the kernel (or the wrapper
raises); a CPU tensor to the plain version beside each wrapper (the backward
ones by autograd of ``ops/conv.py:ico_conv_s2s`` in float32).
"""

from __future__ import annotations

import torch

from geniconet_tpu_torch.ops.conv import ico_conv_s2s
from geniconet_tpu_torch.ops.kernels import build
from geniconet_tpu_torch.ops.kernels.build import act_apply, check_act, expect, grid_level, on_cuda
from geniconet_tpu_torch.ops.kernels.halo import device_table
from geniconet_tpu_torch.ops.kernels.phase_kernel import (
    dx_scratch, dx_tables, fwd_scratch, geff_plain, grid_dtaps_scratch, stats_plain,
)

__all__ = [
    "ico_conv_s2s_fwd", "ico_conv_s2s_fwd_plain", "ico_conv_s2s_dx", "ico_conv_s2s_dx_plain",
    "ico_conv_s2s_dtaps", "ico_conv_s2s_dtaps_plain", "ico_conv_s2s_bwd",
    "ico_conv_s2s_bwd_plain",
]


def _out_grid(h, w, stride):
    """The output grid (h', w') of a stride-``stride`` conv over an (h, w) chart."""
    grid_level(h, w)
    if stride not in (1, 2) or (stride == 2 and h < 2):
        raise ValueError(f"stride must be 1 or 2 over a chart of h >= 2, got {stride} at {h}")
    return h // stride, w // stride


def ico_conv_s2s_fwd_plain(x, taps, bias, corner_mode="average", act=None, with_stats=False,
                           stride=1):
    """Plain version: act prologue, ``ico_pad``, masked 3×3 conv, fp32 sums."""
    out = ico_conv_s2s(act_apply(x, act), taps, bias, grid_level(x.shape[2], x.shape[3]), stride,
                       corner_mode)
    return (out, stats_plain([out])) if with_stats else out


def ico_conv_s2s_fwd(x, taps, bias, corner_mode: str = "average", act=None,
                     with_stats: bool = False, stride: int = 1):
    """Hex conv (B, 5, h, w, C_in) -> (B, 5, h/stride, w/stride, C_out).

    taps (7, C_in, C_out) and bias (C_out,) or None in x's dtype (float32 or
    bfloat16); act: optional float32 (mul, add), each (C_in,), applied as
    relu(x·mul + add) before the halo. With ``with_stats`` also returns the
    float32 (2, C_out) [Σy, Σy²] of the downcast output over the batch. In
    bf16 the phase conv's kernels over the one grid (``phase_conv_fwd``)."""
    if not on_cuda(x, "ico_conv_s2s_fwd"):
        return ico_conv_s2s_fwd_plain(x, taps, bias, corner_mode, act, with_stats, stride)
    B, _, h, w, cin = x.shape
    ho, wo = _out_grid(h, w, stride)
    cout = taps.shape[-1]
    dev, dt = x.device, x.dtype
    expect(x, (B, 5, h, w, cin), dt, dev, "x")
    expect(taps, (7, cin, cout), dt, dev, "taps")
    if bias is not None:
        expect(bias, (cout,), dt, dev, "bias")
    check_act(act, cin, dev, "ico_conv_s2s_fwd")
    out = torch.empty((B, 5, ho, wo, cout), dtype=dt, device=dev)
    table = device_table("std", h, w, corner_mode, dev, stride)
    mul, add = act if act is not None else (None, None)
    # the operand's 5hw input cells are 4·5h'w' at stride 2: the stride-2
    # phase conv's 4 sources over its output grid
    (stats,), ws, operand, wpack = fwd_scratch(dt, B, ho, wo, cin, 1, cout, stride**2, 1,
                                               with_stats, dev)
    with torch.cuda.device(dev):
        err = build.library().gn_ico_conv_fwd(
            x.data_ptr(), build.ptr(mul), build.ptr(add), taps.data_ptr(), build.ptr(bias),
            out.data_ptr(), table.data_ptr(), build.ptr(ws), build.ptr(stats),
            build.ptr(operand), build.ptr(wpack), B, h, w, cin, cout, stride,
            int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("ico_conv_s2s_fwd", err)
    build.LAUNCHES["ico_conv_s2s_fwd"] += 1
    return (out, stats) if with_stats else out


def ico_conv_s2s_dx_plain(g, taps, corner_mode, dtype, act=None, raw=None, y=None, gs=None,
                          emit_gsum=False, stride=1):
    """Plain version of ``ico_conv_s2s_dx``: the conv and halo transposes in
    float32 (autograd of the plain conv, linear in its input), then the act
    adjoint, rounded once to ``dtype``."""
    (g,) = geff_plain([g], [y], gs)
    B, _, ho, wo, _ = g.shape
    h, w = ho * stride, wo * stride
    with torch.enable_grad():
        leaf = torch.zeros((B, 5, h, w, taps.shape[1]), dtype=torch.float32, device=g.device,
                           requires_grad=True)
        out = ico_conv_s2s(leaf, taps.float(), None, grid_level(h, w), stride, corner_mode)
        (d,) = torch.autograd.grad(out, [leaf], [g.float()])
    gsum = g.float().sum(dim=(0, 1, 2, 3)) if emit_gsum else None
    if act is None:
        return d.to(dtype), None, None, gsum
    mul, add = act
    x32 = raw.float()
    dm = d * (x32 * mul + add > 0.0).float()
    return (dm * mul).to(dtype), (dm * x32).sum(dim=(0, 1, 2, 3)), dm.sum(dim=(0, 1, 2, 3)), gsum


def ico_conv_s2s_dx(g, taps, corner_mode, dtype, act=None, raw=None, y=None, gs=None,
                    emit_gsum=False, stride: int = 1):
    """Input cotangent of the standard conv (the Pallas ``_pallas_dx``).

    g: the output cotangent (B, 5, h', w', C_out) in ``dtype`` of a conv
    over a (B, 5, h, w, C_in) input, h' = h/stride; taps (7, C_in,
    C_out) in ``dtype``; act and raw: the forward's prologue and RAW input,
    which make the result the cotangent of the raw input (dx'·mul·1{x·mul +
    add > 0}) and add d_mul, d_add (float32 (C_in,), summed over batch and
    cells); y / gs switch on the fold; ``emit_gsum`` adds Σg_eff (float32
    (C_out,), the bias gradient). Returns (dx, d_mul, d_add, gsum). In
    bf16 the cotangent pass, the transposed tap pack and the tensor-core
    GEMM with the act adjoint in its epilogue, then the sums; in float32
    the SIMT gather-GEMM over ``halo.std_dx_table``."""
    if not on_cuda(g, "ico_conv_s2s_dx"):
        return ico_conv_s2s_dx_plain(g, taps, corner_mode, dtype, act, raw, y, gs, emit_gsum,
                                     stride)
    B, _, ho, wo, cout = g.shape
    h, w = ho * stride, wo * stride
    _out_grid(h, w, stride)
    cin, dev = taps.shape[1], g.device
    expect(g, (B, 5, ho, wo, cout), dtype, dev, "ico_conv_s2s_dx g")
    expect(taps, (7, cin, cout), dtype, dev, "ico_conv_s2s_dx taps")
    if y is not None:
        expect(y, (B, 5, ho, wo, cout), dtype, dev, "ico_conv_s2s_dx y")
        expect(gs, (2, cout), torch.float32, dev, "ico_conv_s2s_dx gs")
    check_act(act, cin, dev, "ico_conv_s2s_dx")
    if act is not None:
        expect(raw, (B, 5, h, w, cin), dtype, dev, "ico_conv_s2s_dx raw")
    M = 5 * ho * wo
    dx = torch.empty((B, 5, h, w, cin), dtype=dtype, device=dev)
    tables, n_comb = dx_tables("std", dtype, h, w, corner_mode, dev, stride=stride)
    mul, add = act if act is not None else (None, None)
    # the GEMM's 5hw input rows are 4·5h'w' at stride 2 (n_in 4 over the
    # output grid sizes the same scratch)
    red, operand, wpack, _ = dx_scratch(dtype, B, ho, wo, cin, 1, cout, 1, n_comb,
                                        act is not None, False, dev, n_in=stride**2)
    dmul = dadd = None
    if act is not None:
        dmul, dadd = (torch.empty(cin, dtype=torch.float32, device=dev) for _ in range(2))
    gsum_ws = gsum = None
    if emit_gsum:
        gsum_ws = build.scratch(-(-B * M // build.GSUM_ROWS) * cout, dev)
        gsum = torch.empty(cout, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().gn_ico_conv_dx(
            g.data_ptr(), build.ptr(y), build.ptr(gs), taps.data_ptr(),
            build.ptr(raw if act is not None else None), build.ptr(mul), build.ptr(add),
            dx.data_ptr(), *map(build.ptr, tables), build.ptr(operand), build.ptr(wpack),
            build.ptr(red), build.ptr(dmul), build.ptr(dadd), build.ptr(gsum_ws), build.ptr(gsum),
            B, h, w, cin, cout, stride, n_comb, build.GSUM_ROWS, build.dtype_code(dtype),
            build.stream_ptr(dev),
        )
    build.check("ico_conv_s2s_dx", err)
    build.LAUNCHES["ico_conv_s2s_dx"] += 1
    return dx, dmul, dadd, gsum


def ico_conv_s2s_dtaps_plain(x, g, corner_mode, act=None, y=None, gs=None, stride=1):
    """Plain version of ``ico_conv_s2s_dtaps``."""
    (g,) = geff_plain([g], [y], gs)
    xa = act_apply(x, act)
    with torch.enable_grad():
        leaf = torch.zeros((7, x.shape[-1], g.shape[-1]), dtype=torch.float32, device=x.device,
                           requires_grad=True)
        out = ico_conv_s2s(xa, leaf, None, grid_level(x.shape[2], x.shape[3]), stride,
                           corner_mode)
        (d,) = torch.autograd.grad(out, [leaf], [g])
    return d.to(x.dtype)


def ico_conv_s2s_dtaps(x, g, corner_mode, act=None, y=None, gs=None, stride: int = 1):
    """Tap cotangent of the standard conv summed over the batch (the Pallas
    ``_pallas_dtaps``): (7, C_in, C_out), float32 sums rounded to x's dtype.
    x: the RAW input; act, y, gs, stride as for ``ico_conv_s2s_dx``. In bf16 two
    kernels and the fixed-order sum: the operand pass and the tensor-core
    GEMM over its rows; in float32 the SIMT GEMM."""
    if not on_cuda(x, "ico_conv_s2s_dtaps"):
        return ico_conv_s2s_dtaps_plain(x, g, corner_mode, act, y, gs, stride)
    B, _, h, w, cin = x.shape
    ho, wo = _out_grid(h, w, stride)
    dev, dt = x.device, x.dtype
    cout = g.shape[-1]
    expect(x, (B, 5, h, w, cin), dt, dev, "ico_conv_s2s_dtaps x")
    expect(g, (B, 5, ho, wo, cout), dt, dev, "ico_conv_s2s_dtaps g")
    if y is not None:
        expect(y, (B, 5, ho, wo, cout), dt, dev, "ico_conv_s2s_dtaps y")
        expect(gs, (2, cout), torch.float32, dev, "ico_conv_s2s_dtaps gs")
    check_act(act, cin, dev, "ico_conv_s2s_dtaps")
    kc, n_chunks, ws, operand = grid_dtaps_scratch(dt, B, ho, wo, cin, cout, stride**2, 1, dev)
    dtaps = torch.empty((7, cin, cout), dtype=dt, device=dev)
    table = device_table("std", h, w, corner_mode, dev, stride)
    mul, add = act if act is not None else (None, None)
    with torch.cuda.device(dev):
        err = build.library().gn_ico_conv_dtaps(
            x.data_ptr(), build.ptr(mul), build.ptr(add), g.data_ptr(), build.ptr(y),
            build.ptr(gs), table.data_ptr(), ws.data_ptr(), dtaps.data_ptr(), build.ptr(operand),
            B, h, w, cin, cout, stride, kc, n_chunks, int(corner_mode == "zeros"),
            build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("ico_conv_s2s_dtaps", err)
    build.LAUNCHES["ico_conv_s2s_dtaps"] += 1
    return dtaps


def ico_conv_s2s_bwd_plain(x, g, taps, y=None, gs=None, corner_mode="average", act=None,
                           with_stats=False, out_dtype=None, stride=1):
    """Plain version of ``ico_conv_s2s_bwd``: ``ico_conv_s2s_dx_plain`` and
    ``ico_conv_s2s_dtaps_plain`` over one shared fold."""
    if with_stats:
        (g,) = geff_plain([g], [y], gs)
    dx, dmul, dadd, gsum = ico_conv_s2s_dx_plain(g, taps, corner_mode, out_dtype or x.dtype, act,
                                                 x, emit_gsum=True, stride=stride)
    return (dx, ico_conv_s2s_dtaps_plain(x, g, corner_mode, act, stride=stride), gsum, dmul,
            dadd)


def ico_conv_s2s_bwd(x, g, taps, y=None, gs=None, corner_mode: str = "average", act=None,
                     with_stats: bool = False, out_dtype=None, stride: int = 1):
    """The merged standard-conv backward (the Pallas ``_std_bwd``): dx,
    dtaps and Σg_eff of one conv in one launch.

    x: the RAW input (B, 5, h, w, C_in); g: the output cotangent (B, 5,
    h/stride, w/stride, C_out) in x's dtype; taps (7, C_in, C_out); with
    ``with_stats``, y and
    gs switch on the fold; act: the forward's prologue, which makes dx the
    raw input's cotangent and adds d_mul, d_add; out_dtype: x's dtype.
    Returns (dx, dtaps rounded to x's dtype (as ``_bwd`` rounds them),
    float32 Σg_eff (C_out,), d_mul, d_add (float32 (C_in,), or None without
    act)). In bf16 ``ico_conv_s2s_dx``'s cotangent pass and
    ``ico_conv_s2s_dtaps``' operand pass (with their tables, scratch and
    split), one launch of both tensor-core GEMMs, then the sums: the outputs
    equal ``ico_conv_s2s_dx(..., emit_gsum=True)`` + ``ico_conv_s2s_dtaps``
    bit for bit. In float32 one launch of the SIMT tiles of both roles, then
    the sums."""
    if not on_cuda(x, "ico_conv_s2s_bwd"):
        return ico_conv_s2s_bwd_plain(x, g, taps, y, gs, corner_mode, act, with_stats,
                                      out_dtype, stride)
    B, _, h, w, cin = x.shape
    ho, wo = _out_grid(h, w, stride)
    dev, dt = x.device, x.dtype
    if out_dtype not in (None, dt):
        raise TypeError(f"ico_conv_s2s_bwd: out_dtype {out_dtype} is not the input's {dt}")
    cout = taps.shape[-1]
    expect(x, (B, 5, h, w, cin), dt, dev, "ico_conv_s2s_bwd x")
    expect(g, (B, 5, ho, wo, cout), dt, dev, "ico_conv_s2s_bwd g")
    expect(taps, (7, cin, cout), dt, dev, "ico_conv_s2s_bwd taps")
    if not with_stats:
        y = gs = None
    if y is not None:
        expect(y, (B, 5, ho, wo, cout), dt, dev, "ico_conv_s2s_bwd y")
        expect(gs, (2, cout), torch.float32, dev, "ico_conv_s2s_bwd gs")
    check_act(act, cin, dev, "ico_conv_s2s_bwd")
    M = 5 * ho * wo
    dx = torch.empty((B, 5, h, w, cin), dtype=dt, device=dev)
    tables, n_comb = dx_tables("std", dt, h, w, corner_mode, dev, stride=stride)
    red, operand, wpack, _ = dx_scratch(dt, B, ho, wo, cin, 1, cout, 1, n_comb, act is not None,
                                        False, dev, n_in=stride**2)
    if dt == torch.bfloat16:
        kc, n_chunks, ws, grid_op = grid_dtaps_scratch(dt, B, ho, wo, cin, cout, stride**2, 1,
                                                       dev)
        gpart = build.scratch(-(-B * M // build.GSUM_ROWS) * cout, dev)
    else:
        grid_op = None
        kc, n_chunks, ws, gpart = build.merged_scratch(B * M, cin, cout, dev)
    table = device_table("std", h, w, corner_mode, dev, stride)
    mul, add = act if act is not None else (None, None)
    dmul = dadd = None
    if act is not None:
        dmul, dadd = (torch.empty(cin, dtype=torch.float32, device=dev) for _ in range(2))
    dtaps = torch.empty((7, cin, cout), dtype=dt, device=dev)
    gsum = torch.empty(cout, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().gn_ico_conv_bwd(
            x.data_ptr(), build.ptr(mul), build.ptr(add), g.data_ptr(), build.ptr(y),
            build.ptr(gs), taps.data_ptr(), dx.data_ptr(), *map(build.ptr, tables),
            table.data_ptr(), build.ptr(red), build.ptr(dmul), build.ptr(dadd), ws.data_ptr(),
            dtaps.data_ptr(), gpart.data_ptr(), gsum.data_ptr(), build.ptr(operand),
            build.ptr(wpack), build.ptr(grid_op), B, h, w, cin, cout, stride, kc, n_chunks,
            n_comb, build.GSUM_ROWS, int(corner_mode == "zeros"), build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("ico_conv_s2s_bwd", err)
    build.LAUNCHES["ico_conv_s2s_bwd"] += 1
    return dx, dtaps, gsum, dmul, dadd

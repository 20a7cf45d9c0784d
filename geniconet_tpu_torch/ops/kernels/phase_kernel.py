"""Phase-domain hex-conv kernels: phase conv, upsample + dual conv, pair head,
and the backward kernels of the first two.

Port of ``geniconet_tpu/ops/pallas/phase_kernel.py``:

* ``phase_conv_fwd``     -> ``csrc/phase_conv.cu`` (``_phase_conv_fwd``, for
  ``fused_phase_conv_s1`` and ``fused_dual_s2_conv``: 4 phases in; all 4
  output phases, or phase 2 alone for stride 2; 1 or 2 tap sets; optional
  act prologue; optional BatchNorm ``[Σy, Σy²]`` stats); in bf16 it writes
  the act-applied operand once (``grid_operand``'s pass) and runs the
  tensor-core GEMM with the stats epilogue over its gathered rows
  (``csrc/mma_conv_fwd.cuh``, as the up conv's forward), in float32 the
  SIMT GEMM; the standard conv's forward is the same launcher;
* ``up_dual_conv_fwd``   -> ``csrc/up_conv.cu`` (``_up_conv_fwd_impl``); in
  bf16 it builds the upsampled operand once and runs a tensor-core GEMM
  over its gathered rows with the stats in its epilogue
  (``csrc/mma_conv_fwd.cuh``), in float32 the SIMT GEMM;
* ``pair_head_fwd`` / ``pair_head_bwd`` -> ``csrc/pair_head.cu`` (``_phead`` /
  ``_phead_bwd``: the decoder's tail + head + tanh and its backward);
* ``pair_head_mse_fwd`` / ``pair_head_mse_bwd`` -> ``csrc/pair_head.cu``
  (``_phmse`` / ``_phmse_bwd``: the head fused with the AE's position loss);
* ``phase_conv_dx`` / ``phase_conv_dtaps`` -> ``csrc/phase_conv_bwd.cu``
  (``_phase_conv_dx`` / ``_phase_conv_dtaps``); in bf16 the dx writes the
  folded cotangent once with its combined rows (``cot_operand_plain`` says
  which row is which) and runs the forward's tensor-core GEMM transposed
  over the rows ``halo.phase_dx_codes`` names, the act adjoint in its
  epilogue (``csrc/mma_conv_fwd.cuh``), and the dtaps writes the
  act-applied operand once (``grid_operand``, also callable alone, shared
  with the standard conv's dtaps) and runs the tensor-core GEMM over its
  gathered rows (``csrc/mma_dtaps.cuh``); in float32 both the SIMT GEMMs;
* ``up_dual_conv_dx`` / ``up_dual_conv_dtaps`` -> ``csrc/up_conv_bwd.cu``
  (the two kernels of ``_upd_bwd``); in bf16 the dx is the stride-1 phase
  conv's tensor-core dx into the float32 cotangent of the 4 upsampled
  phases, then the upsample adjoint (``halo.up_adjoint_table``), and the
  dtaps builds the upsampled operand once (``up_operand``, also callable
  alone) and runs a tensor-core GEMM over its gathered rows
  (``csrc/mma_dtaps.cuh``); in float32 the SIMT GEMMs, which rebuild each
  operand element on load;
* ``phase_conv_bwd`` -> ``csrc/phase_conv_bwd.cu`` (``_phase_conv_bwd``) and
  ``up_dual_conv_bwd`` -> ``csrc/up_conv_bwd.cu`` (``_upd_bwd``'s merged
  branch): the merged backward, every output of the split pair (dx with
  the act adjoint, dtaps, Σg_eff, d_mul/d_add); in bf16 the split route's
  passes over one folded cotangent and one launch of both tensor-core
  GEMMs (``csrc/mma_merged_bwd.cuh``), in float32 one launch of the SIMT
  tiles of both roles;
* ``stats_geff`` -> ``csrc/stats_geff.cu`` (``_stats_geff``): the stats
  fold outside the conv kernels, for the kernel families that do not fold
  in-kernel (the ``kernel_geff`` option);
* ``ds2s_fwd`` / ``ds2s_dx`` / ``ds2s_dtaps`` -> ``csrc/ds2s.cu`` (``_ds2s``
  and the two kernels of ``_ds2s_bwd``): the phase chain's stride-2 conv,
  whose outputs and their cotangents are the 4 parity phases of the
  level-(s-1) grid (in bf16 its dx and dtaps are ``phase_conv_dx``'s and
  ``phase_conv_dtaps``' tensor-core paths reading those phases);
* ``up_pair_fwd`` / ``up_pair_dx`` / ``up_pair_dtaps`` -> ``csrc/up_pair.cu``
  (``_updp`` and the two kernels of ``_updp_bwd``): the decoder's phase
  chain, the up conv whose level-s input is the previous UpBlock's residual
  join of a raw phase pair, and whose dx is that pair's 8 phase cotangents
  and 4 affine gradients (the bf16 forward and dtaps as the up conv's, on
  the pair joined once: ``up_pair_operand``; the bf16 dx as the up conv's,
  with the join's adjoint in its last pass);
* ``up_block_fwd`` -> ``csrc/up_block.cu`` (``_up_block_fwd_impl``, kernel
  o) and ``dn_block_fwd`` -> ``csrc/dn_block.cu`` (``_dn_block_fwd_impl``,
  kernel p): a whole UpBlock's or DownBlock's training forward in one
  launch, the block's two first convs with stats, bn00's affine computed
  in the kernel from their moments, then conv01 with the affine as its
  prologue, with stats (the merged blocks; their backward is the existing
  kernels', ``ops/kernels/fused.py``).

The backward wrappers keep the Pallas calls' contracts: ``y_groups`` and
``gs_list`` (the forward outputs and the cotangents of their stats) switch
on the in-kernel fold g_eff = g + gs0 + 2·gs1·y, rounded to the activation
dtype; Σg_eff per tap set is the bias gradient. The custom VJPs built from
them (and the head+MSE's) are in ``ops/kernels/fused.py``.

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain PyTorch version beside each wrapper, built from ``ops/phase.py``
(the backward ones by autograd of the plain forward, in float32).
"""

from __future__ import annotations

import numpy as np
import torch

from geniconet_tpu_torch.ops.kernels import build
from geniconet_tpu_torch.ops.kernels.build import (
    act_apply, check_act, expect, grid_level, on_cuda,
)
from geniconet_tpu_torch.ops.conv import ico_conv_s2s
from geniconet_tpu_torch.ops.kernels.halo import (
    device_dx_codes, device_dx_table, device_table, phase_dx_codes, std_dx_codes,
)
from geniconet_tpu_torch.ops.pad import chart_mean, ico_pad
from geniconet_tpu_torch.ops.phase import phase_conv, phase_merge, phase_split, phase_upsample

__all__ = [
    "stats_geff", "ds2s_fwd", "ds2s_fwd_plain", "ds2s_dx", "ds2s_dx_plain", "ds2s_dtaps",
    "ds2s_dtaps_plain", "up_pair_fwd", "up_pair_fwd_plain", "up_pair_dx", "up_pair_dx_plain",
    "up_pair_dtaps", "up_pair_dtaps_plain",
    "phase_conv_fwd", "phase_conv_fwd_plain",
    "up_dual_conv_fwd", "up_dual_conv_fwd_plain",
    "pair_head_fwd", "pair_head_fwd_plain", "pair_head_bwd", "pair_head_bwd_plain",
    "pair_head_mse_fwd", "pair_head_mse_fwd_plain",
    "pair_head_mse_bwd", "pair_head_mse_bwd_plain",
    "phase_conv_dx", "phase_conv_dx_plain", "phase_conv_dtaps", "phase_conv_dtaps_plain",
    "operand_rows", "up_operand", "up_operand_plain", "up_pair_operand",
    "up_pair_operand_plain", "grid_operand_rows", "grid_operand", "grid_operand_plain",
    "grid_dtaps_scratch", "fwd_scratch", "dx_tables", "dx_scratch", "cot_operand_plain",
    "up_dual_conv_dx", "up_dual_conv_dx_plain", "up_dual_conv_dtaps",
    "up_dual_conv_dtaps_plain", "phase_conv_bwd", "phase_conv_bwd_plain", "up_dual_conv_bwd",
    "up_dual_conv_bwd_plain", "stats_plain", "geff_plain", "pair_join", "bn_affine_plain",
    "up_block_fwd", "up_block_fwd_plain", "dn_block_fwd", "dn_block_fwd_plain",
]

_OUT_PHASES = ((0, 1, 2, 3), (2,))
_ALL = (0, 1, 2, 3)


def _check_out_phases(out_phases, name):
    out_phases = tuple(out_phases)
    if out_phases not in _OUT_PHASES:
        raise ValueError(f"{name}: out_phases must be one of {_OUT_PHASES}")
    return out_phases


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


def _pair(ts):
    """Two pointers from a list of 1 or 2 tensors (the second may be absent)."""
    return [build.ptr(ts[0]), build.ptr(ts[1]) if len(ts) > 1 else None]


def stats_plain(outs):
    """[Σy, Σy²] (2, C) float32 over every position of the (downcast) arrays."""
    s = sum(o.float().sum(dim=tuple(range(o.dim() - 1))) for o in outs)
    ss = sum(o.float().square().sum(dim=tuple(range(o.dim() - 1))) for o in outs)
    return torch.stack([s, ss])


def geff_plain(g_group, y_group, gs):
    """The stats-cotangent fold g_eff = g + gs0 + 2·gs1·y in float32, cast to
    g's dtype (``conv_kernel.py:_geff_one``); no fold when gs is None."""
    if gs is None:
        return tuple(g_group)
    return tuple((g.float() + gs[0] + 2.0 * y.float() * gs[1]).to(g.dtype)
                 for g, y in zip(g_group, y_group))


def _fold_groups(g_groups, y_groups, gs_list):
    if y_groups is None:
        return [tuple(g) for g in g_groups]
    return [geff_plain(g, y, gs) for g, y, gs in zip(g_groups, y_groups, gs_list)]


def _check_cotangents(g_groups, y_groups, gs_list, shape, dt, dev, name):
    cout = shape[-1]
    for s, group in enumerate(g_groups):
        for g in group:
            expect(g, shape, dt, dev, f"{name} g (set {s})")
        if y_groups is not None:
            for y in y_groups[s]:
                expect(y, shape, dt, dev, f"{name} y (set {s})")
            expect(gs_list[s], (2, cout), torch.float32, dev, f"{name} gs (set {s})")


def _fold_ptrs(g_groups, y_groups, gs_list):
    """Host pointer arrays of g (set-major), y (or null), and the gs pair."""
    gp = build.ptr_array([g for group in g_groups for g in group])
    if y_groups is None:
        return gp, None, None, None
    yp = build.ptr_array([y for group in y_groups for y in group])
    return (gp, yp, *_pair(gs_list))


def _gsum_outputs(rows, n_sets, cout, dev):
    """Scratch and outputs of the Σg pass over ``rows`` rows of g."""
    parts = -(-rows // build.GSUM_ROWS)
    return (build.scratch(parts * n_sets * cout, dev),
            [torch.empty(cout, dtype=torch.float32, device=dev) for _ in range(n_sets)])


# --------------------------------------------------------------------------
# phase conv (fused_phase_conv_s1 / fused_dual_s2_conv)
# --------------------------------------------------------------------------


def phase_conv_fwd_plain(phases, tap_sets, corner_mode="average", out_phases=(0, 1, 2, 3),
                         act=None, with_stats=False):
    """Plain version: act prologue, then ``ops/phase.py:phase_conv`` per set."""
    phases = tuple(act_apply(p, act) for p in phases)
    sets = [phase_conv(phases, taps, bias, corner_mode, out_phases) for taps, bias in tap_sets]
    return (sets, [stats_plain(o) for o in sets]) if with_stats else sets


def phase_conv_fwd(phases, tap_sets, corner_mode: str = "average", out_phases=(0, 1, 2, 3),
                   act=None, with_stats: bool = False):
    """Hex conv in phase form.

    phases: 4 contiguous (B, 5, h, w, C_in) tensors, float32 or bfloat16.
    tap_sets: 1 or 2 (taps (7, C_in, C_out), bias (C_out,) or None) in the
    same dtype, all with one C_out. out_phases: (0, 1, 2, 3) for the
    stride-1 conv, (2,) for the stride-2 conv (standard level-(s-1) output).
    act: optional float32 (mul, add), each (C_in,), the relu(x·mul + add)
    prologue applied before the halo.
    Returns, per tap set, a tuple of (B, 5, h, w, C_out) output phases; with
    ``with_stats`` also, per set, the float32 (2, C_out) [Σy, Σy²] of the
    downcast outputs over every phase and the whole batch. In bf16 up to
    four kernels: the operand pass, the taps packed, the tensor-core GEMM
    and the stats' fixed-order sum; in float32 the SIMT GEMM and the sum.
    """
    out_phases = _check_out_phases(out_phases, "phase_conv_fwd")
    if len(phases) != 4:
        raise ValueError(f"phase_conv_fwd: takes 4 phases, got {len(phases)}")
    x0 = phases[0]
    if not on_cuda(x0, "phase_conv_fwd"):
        return phase_conv_fwd_plain(phases, tap_sets, corner_mode, out_phases, act, with_stats)
    B, _, h, w, cin = x0.shape
    grid_level(h, w)
    dev, dt = x0.device, x0.dtype
    for i, p in enumerate(phases):
        expect(p, (B, 5, h, w, cin), dt, dev, f"phase_conv_fwd phase {i}")
    cout = _check_sets(tap_sets, cin, dt, dev, "phase_conv_fwd")
    check_act(act, cin, dev, "phase_conv_fwd")
    n_sets, n_out = len(tap_sets), len(out_phases)
    outs = _phase_outputs(n_sets * n_out, (B, 5, h, w, cout), dt, dev)
    table = device_table("phase", h, w, corner_mode, dev)
    mul, add = act if act is not None else (None, None)
    stats, ws, operand, wpack = fwd_scratch(dt, B, h, w, cin, n_sets, cout, 4, n_out,
                                            with_stats, dev)
    with torch.cuda.device(dev):
        err = build.library().gn_phase_conv_fwd(
            *[p.data_ptr() for p in phases], build.ptr(mul), build.ptr(add),
            *_set_ptrs(tap_sets), build.ptr_array(outs), table.data_ptr(), build.ptr(ws),
            *_pair(stats), build.ptr(operand), build.ptr(wpack), B, h, w, cin, cout, n_sets,
            out_phases[0], n_out, int(corner_mode == "zeros"), build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("phase_conv_fwd", err)
    build.LAUNCHES["phase_conv_fwd"] += 1
    sets = [tuple(outs[i * n_out : (i + 1) * n_out]) for i in range(n_sets)]
    return (sets, stats) if with_stats else sets


def _stats_outputs(with_stats, partial_rows, n_sets, cout, dev):
    """(per-set (2, C_out) float32 outputs, scratch of the block partials)."""
    if not with_stats:
        return [None], None
    stats = [torch.empty((2, cout), dtype=torch.float32, device=dev) for _ in range(n_sets)]
    return stats, build.scratch(partial_rows * 2 * n_sets * cout, dev)


def fwd_scratch(dt, B, h, w, cin, n_sets, cout, n_src, n_out, with_stats, dev):
    """(stats outputs, their block partials, operand, packed taps) of a
    forward into n_out output phases of n_sets tap sets whose operand has
    n_src sources a sample (the up convs': 4 upsampled phases, 4 output
    phases; the grid convs': 4 phases or 1 grid): float32 the SIMT GEMM's
    partials (a row per 64-row tile of each sample and output phase) and
    no scratch; bf16 the tensor-core GEMM's (a row per row tile), and the
    operand and packed-taps scratch of its first passes."""
    if dt != torch.bfloat16:
        return (*_stats_outputs(with_stats, B * n_out * build.n_tiles(5 * h * w), n_sets, cout,
                                dev), None, None)
    _, row_tiles = build.mma_fwd_grid(B * n_out * 5 * h * w, n_sets * cout)
    operand = torch.empty((grid_operand_rows(B, h, w, n_src), build.operand_width(cin)),
                          dtype=dt, device=dev)
    wpack = torch.empty(build.packed_taps_shape(cin, n_sets * cout), dtype=dt, device=dev)
    return (*_stats_outputs(with_stats, row_tiles, n_sets, cout, dev), operand, wpack)


def dx_tables(kind, dtype, h, w, corner_mode, dev, out_phases=_ALL, stride=1):
    """(the 8 table pointers' tensors of the dx C entries of a, c and f,
    combined rows a sample): float32 the transposed CSR
    (``halo.phase_dx_table``, ``up_dx_table`` for ``"up"``, ``std_dx_table``
    for ``"std"`` at ``stride`` over an (h, w) input) and no bf16 tables;
    bf16 no CSR and the code table, combined rows and tap masks
    (``halo.phase_dx_codes``, or ``std_dx_codes`` for ``"std"``)."""
    if dtype != torch.bfloat16:
        csr = device_dx_table(kind, h, w, corner_mode, dev,
                              out_phases if kind == "phase" else None, stride)
        return (*csr, None, None, None, None, None), 0
    codes, c_off, c_cells, c_w, mask, n_comb = device_dx_codes(
        h, w, corner_mode, dev, None if kind == "std" else out_phases, stride)
    return (None, None, None, codes, c_off, c_cells, c_w, mask), n_comb


def dx_scratch(dt, B, h, w, cin, n_sets, cout, n_out, n_comb, with_act, up, dev, n_in=4):
    """(act partials, cotangent operand, packed taps, dU) of the phase conv's
    (a), the up conv's (c, ``up``) or the standard conv's (f, ``n_in`` = 1
    input grid) dx into C_in channels of n_in input phases from n_sets sets
    of n_out cotangent phases of C_out: float32 the SIMT GEMM's [d_mul |
    d_add] partials (a row per 64-row tile of each sample) and no scratch;
    bf16 the tensor-core GEMM's partials (a row per row tile), the written
    cotangent (``build.cot_operand_shape``, n_comb combined rows a sample),
    the transposed taps (``build.dx_packed_taps_shape``) and for c the
    float32 cotangent of the 4 upsampled phases, (B, 4, 5hw, C_in)."""
    M, ntot = 5 * h * w, n_sets * cout
    if dt != torch.bfloat16:
        red = build.scratch(B * build.n_tiles(n_in * M) * 2 * cin, dev) if with_act else None
        return red, None, None, None
    _, row_tiles = build.mma_fwd_grid(B * n_in * M, cin)
    red = build.scratch(row_tiles * 2 * cin, dev) if with_act else None
    operand = torch.empty(build.cot_operand_shape(B, n_out * M, n_comb, ntot), dtype=dt,
                          device=dev)
    wpack = torch.empty(build.dx_packed_taps_shape(cin, ntot), dtype=dt, device=dev)
    du = torch.empty((B, 4, M, cin), dtype=torch.float32, device=dev) if up else None
    return red, operand, wpack, du


def cot_operand_plain(g_groups, y_groups=None, gs_list=None, corner_mode="average",
                      out_phases=_ALL):
    """Plain version of the dx GEMMs' cotangent operand (a, c, f; the pass
    ``csrc/mma.cuh:cot_operand_pass``): per sample the n_out·5hw rows
    ``slot·M + m`` of g_eff (``geff_plain``), the sets side by side, then its
    combined rows (``halo.phase_dx_codes``, or for ``out_phases=None`` the
    standard conv's ``halo.std_dx_codes`` over its one cotangent: each the
    float32 weighted sum of its rows, rounded to g's dtype once), and after
    the last sample one zero row; the columns padded with zeros to
    ``build.operand_width``."""
    g_groups = _fold_groups(g_groups, y_groups, gs_list)
    B, _, h, w, _ = g_groups[0][0].shape
    n_out = len(g_groups[0])
    rows = torch.cat([torch.stack(group, dim=1).reshape(B, n_out * 5 * h * w, -1)
                      for group in g_groups], dim=-1)
    _, (offsets, cells, weights), _ = (
        std_dx_codes(h, w, corner_mode) if out_phases is None
        else phase_dx_codes(h, w, corner_mode, tuple(out_phases)))
    seg = torch.from_numpy(np.repeat(np.arange(len(offsets) - 1), np.diff(offsets)))
    terms = rows.float()[:, torch.from_numpy(cells).long()] * torch.from_numpy(weights)[:, None]
    comb = rows.new_zeros((B, len(offsets) - 1, rows.shape[-1]), dtype=torch.float32)
    comb = comb.index_add_(1, seg, terms).to(rows.dtype)
    flat_rows = torch.cat([rows, comb], dim=1).reshape(-1, rows.shape[-1])
    out = torch.cat([flat_rows, rows.new_zeros((1, rows.shape[-1]))])
    return torch.nn.functional.pad(out, (0, build.operand_width(rows.shape[-1]) - rows.shape[-1]))


def _phase_adjoint(g_groups, tap_sets, corner_mode, out_phases, shape):
    """dL/d(activated input phases), float32, by autograd of the plain conv
    (linear in its input, so the input's values do not matter)."""
    dev = g_groups[0][0].device
    leaf = [torch.zeros(shape, dtype=torch.float32, device=dev, requires_grad=True)
            for _ in range(4)]
    outs, grads = [], []
    for (taps, _), group in zip(tap_sets, g_groups):
        outs += phase_conv(leaf, taps.float(), None, corner_mode, out_phases)
        grads += [g.float() for g in group]
    return torch.autograd.grad(outs, leaf, grads)


def phase_conv_dx_plain(g_groups, tap_sets, corner_mode, out_phases, cin, dtype, act=None,
                        raw_phases=None, y_groups=None, gs_list=None):
    """Plain version of ``phase_conv_dx``: the conv and halo transposes in
    float32, then the act adjoint, rounded once to ``dtype``."""
    g_groups = _fold_groups(g_groups, y_groups, gs_list)
    B, _, h, w, _ = g_groups[0][0].shape
    with torch.enable_grad():
        d = _phase_adjoint(g_groups, tap_sets, corner_mode, out_phases, (B, 5, h, w, cin))
    gsums = None
    if y_groups is not None:
        gsums = [sum(g.float().sum(dim=(0, 1, 2, 3)) for g in group) for group in g_groups]
    if act is None:
        return tuple(t.to(dtype) for t in d), None, None, gsums
    mul, add = act
    dphases, dmul, dadd = [], 0.0, 0.0
    for t, x in zip(d, raw_phases):
        x32 = x.float()
        dm = t * (x32 * mul + add > 0.0).float()
        dphases.append((dm * mul).to(dtype))
        dmul = dmul + (dm * x32).sum(dim=(0, 1, 2, 3))
        dadd = dadd + dm.sum(dim=(0, 1, 2, 3))
    return tuple(dphases), dmul, dadd, gsums


def phase_conv_dx(g_groups, tap_sets, corner_mode, out_phases, cin, dtype, act=None,
                  raw_phases=None, y_groups=None, gs_list=None):
    """Input cotangent of the phase conv (the Pallas ``_phase_conv_dx``).

    g_groups: per tap set, the cotangents of its output phases (B, 5, h, w,
    C_out) in ``dtype``; tap_sets: (taps, bias) as in the forward (bias is
    not read); act and raw_phases: the forward's prologue and RAW input
    phases, which make the result the cotangent of the raw input
    (dx' · mul · 1{x·mul + add > 0}) and add d_mul, d_add (float32 (C_in,),
    summed over batch and cells). y_groups / gs_list switch on the fold and
    the Σg_eff outputs. Returns (4 dphases, d_mul, d_add, gsums). In bf16
    the cotangent pass, the transposed tap pack and the tensor-core GEMM
    with the act adjoint in its epilogue (``dx_scratch``), then the sums; in
    float32 the SIMT gather-GEMM over ``halo.phase_dx_table``.
    """
    out_phases = _check_out_phases(out_phases, "phase_conv_dx")
    g0 = g_groups[0][0]
    if not on_cuda(g0, "phase_conv_dx"):
        return phase_conv_dx_plain(g_groups, tap_sets, corner_mode, out_phases, cin, dtype,
                                   act, raw_phases, y_groups, gs_list)
    B, _, h, w, cout = g0.shape
    grid_level(h, w)
    dev, n_sets, n_out = g0.device, len(tap_sets), len(out_phases)
    if len(g_groups) != n_sets or any(len(g) != n_out for g in g_groups):
        raise ValueError("phase_conv_dx: one cotangent per tap set and output phase")
    _check_cotangents(g_groups, y_groups, gs_list, (B, 5, h, w, cout), dtype, dev,
                      "phase_conv_dx")
    _check_sets(tap_sets, cin, dtype, dev, "phase_conv_dx")
    check_act(act, cin, dev, "phase_conv_dx")
    if act is not None:
        for i, x in enumerate(raw_phases):
            expect(x, (B, 5, h, w, cin), dtype, dev, f"phase_conv_dx raw phase {i}")
    outs = [torch.empty((B, 5, h, w, cin), dtype=dtype, device=dev) for _ in range(4)]
    tables, n_comb = dx_tables("phase", dtype, h, w, corner_mode, dev, out_phases)
    mul, add = act if act is not None else (None, None)
    red, operand, wpack, _ = dx_scratch(dtype, B, h, w, cin, n_sets, cout, n_out, n_comb,
                                        act is not None, False, dev)
    dmul = dadd = None
    if act is not None:
        dmul, dadd = (torch.empty(cin, dtype=torch.float32, device=dev) for _ in range(2))
    gsum_ws, gsums = (None, [None])
    if y_groups is not None:
        gsum_ws, gsums = _gsum_outputs(B * n_out * 5 * h * w, n_sets, cout, dev)
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    raws = build.ptr_array(raw_phases) if act is not None else None
    with torch.cuda.device(dev):
        err = build.library().gn_phase_conv_dx(
            gp, yp, gs0, gs1, *_pair([t for t, _ in tap_sets]), raws, build.ptr(mul),
            build.ptr(add), build.ptr_array(outs), *map(build.ptr, tables), build.ptr(operand),
            build.ptr(wpack), build.ptr(red), build.ptr(dmul), build.ptr(dadd),
            build.ptr(gsum_ws), *_pair(gsums),
            B, h, w, cin, cout, n_sets, n_out, n_comb, build.GSUM_ROWS, build.dtype_code(dtype),
            build.stream_ptr(dev),
        )
    build.check("phase_conv_dx", err)
    build.LAUNCHES["phase_conv_dx"] += 1
    return tuple(outs), dmul, dadd, (gsums if y_groups is not None else None)


def _dtaps_by_autograd(phases, g_groups, tap_shapes, corner_mode, out_phases):
    """Σ_batch dL/dtaps per set, float32, by autograd of the plain conv over
    the given (already activated, forward-dtype) input phases."""
    leaves = [torch.zeros(s, dtype=torch.float32, device=phases[0].device, requires_grad=True)
              for s in tap_shapes]
    outs, grads = [], []
    for taps, group in zip(leaves, g_groups):
        outs += phase_conv(phases, taps, None, corner_mode, out_phases)
        grads += list(group)
    return torch.autograd.grad(outs, leaves, grads)


def phase_conv_dtaps_plain(phases, g_groups, tap_shapes, corner_mode, out_phases, act=None,
                           y_groups=None, gs_list=None, emit_gsum=False):
    """Plain version of ``phase_conv_dtaps``."""
    g_groups = _fold_groups(g_groups, y_groups, gs_list)
    phases = tuple(act_apply(p, act) for p in phases)
    with torch.enable_grad():
        dtaps = _dtaps_by_autograd(phases, g_groups, tap_shapes, corner_mode, out_phases)
    if not emit_gsum:
        return tuple(dtaps)
    return tuple(dtaps), [sum(g.float().sum(dim=(0, 1, 2, 3)) for g in group)
                          for group in g_groups]


def grid_operand_rows(B, h, w, n_src):
    """Rows of a grid conv's operand: per sample its n_src·5hw cells (the
    phase conv's 4 phases, or the standard conv's 1 grid) and its 2 poles,
    then one zero row."""
    return B * (n_src * 5 * h * w + 2) + 1


def grid_operand_plain(sources, act=None, corner_mode="average"):
    """Plain version of ``grid_operand``: the act-applied sources stacked in
    order, each sample's two poles (``chart_mean`` of cell (0, 0) of the
    first source and of the last cell of the last, i.e. the phase pad's
    poles of the 4 phases (phase ee, phase oq) or ``ico_pad``'s of one grid;
    zeros under ``"zeros"``), a zero row, and the channels padded with zeros
    to ``build.operand_width``."""
    xs = [act_apply(x, act) for x in sources]
    B, _, h, w, cin = xs[0].shape
    cells = torch.stack(xs, dim=1).reshape(B, len(xs) * 5 * h * w, cin)
    if corner_mode == "average":
        poles = torch.stack([chart_mean(xs[0][:, :, 0, 0]),
                             chart_mean(xs[-1][:, :, h - 1, w - 1])], dim=1)
    else:
        poles = xs[0].new_zeros((B, 2, cin))
    rows = torch.cat([torch.cat([cells, poles], dim=1).reshape(-1, cin), xs[0].new_zeros((1, cin))])
    return torch.nn.functional.pad(rows, (0, build.operand_width(cin) - cin))


def grid_operand(sources, act=None, corner_mode: str = "average"):
    """The act-applied operand of a grid conv, as the bf16 dtaps of the phase
    conv (4 phases) and of the standard conv (1 grid) build it before their
    GEMM: ``sources``, 1 or 4 contiguous (B, 5, h, w, C_in) tensors (float32
    or bfloat16), act the optional float32 (mul, add) prologue ->
    (B·(n_src·5hw + 2) + 1, C_in rounded up to 8) in their dtype
    (``grid_operand_plain`` says which row is which)."""
    x0 = sources[0]
    if not on_cuda(x0, "grid_operand"):
        return grid_operand_plain(sources, act, corner_mode)
    if len(sources) not in (1, 4):
        raise ValueError(f"grid_operand: takes 1 or 4 sources, got {len(sources)}")
    B, _, h, w, cin = x0.shape
    grid_level(h, w)
    dev, dt = x0.device, x0.dtype
    for i, x in enumerate(sources):
        expect(x, (B, 5, h, w, cin), dt, dev, f"grid_operand source {i}")
    check_act(act, cin, dev, "grid_operand")
    mul, add = act if act is not None else (None, None)
    out = torch.empty((grid_operand_rows(B, h, w, len(sources)), build.operand_width(cin)),
                      dtype=dt, device=dev)
    with torch.cuda.device(dev):
        err = build.library().gn_grid_operand(
            build.ptr_array(sources), build.ptr(mul), build.ptr(add), out.data_ptr(), B, h, w,
            cin, len(sources), int(corner_mode == "zeros"), build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("grid_operand", err)
    build.LAUNCHES["grid_operand"] += 1
    return out


def grid_dtaps_scratch(dt, B, h, w, cin, ntot, n_src, n_out, dev):
    """(kc, n_chunks, partials, operand) of a grid conv's dtaps over
    B·n_out·5hw rows into (7·C_in, ntot): float32 the SIMT GEMM's split and
    no operand; bf16 the tensor-core GEMM's split (``build.grid_dtaps_split``)
    and the operand scratch of its first pass."""
    rows = B * n_out * 5 * h * w
    if dt == torch.bfloat16:
        kc, n_chunks = build.grid_dtaps_split(rows, cin, ntot)
        operand = torch.empty((grid_operand_rows(B, h, w, n_src), build.operand_width(cin)),
                              dtype=dt, device=dev)
    else:
        kc, n_chunks = build.dtaps_split(rows, build.n_tiles(7 * cin) * build.n_tiles(ntot))
        operand = None
    return kc, n_chunks, build.scratch(n_chunks * 7 * cin * ntot, dev), operand


def phase_conv_dtaps(phases, g_groups, tap_shapes, corner_mode, out_phases, act=None,
                     y_groups=None, gs_list=None, emit_gsum=False):
    """Tap cotangents of the phase conv, summed over the batch (the Pallas
    ``_phase_conv_dtaps``): per set a float32 (7, C_in, C_out); with
    ``emit_gsum`` also the per-set Σg_eff (the bias gradient). In bf16 two
    kernels and the fixed-order sum: the operand pass (``grid_operand``) and
    the tensor-core GEMM over its rows; in float32 the SIMT GEMM."""
    out_phases = _check_out_phases(out_phases, "phase_conv_dtaps")
    x0 = phases[0]
    if not on_cuda(x0, "phase_conv_dtaps"):
        return phase_conv_dtaps_plain(phases, g_groups, tap_shapes, corner_mode, out_phases,
                                      act, y_groups, gs_list, emit_gsum)
    B, _, h, w, cin = x0.shape
    grid_level(h, w)
    dev, dt = x0.device, x0.dtype
    n_sets, n_out = len(g_groups), len(out_phases)
    cout = tap_shapes[0][-1]
    if any(tuple(s) != (7, cin, cout) for s in tap_shapes) or not 1 <= n_sets <= 2:
        raise ValueError(f"phase_conv_dtaps: tap shapes {tap_shapes} for C_in {cin}")
    for i, p in enumerate(phases):
        expect(p, (B, 5, h, w, cin), dt, dev, f"phase_conv_dtaps phase {i}")
    _check_cotangents(g_groups, y_groups, gs_list, (B, 5, h, w, cout), dt, dev,
                      "phase_conv_dtaps")
    check_act(act, cin, dev, "phase_conv_dtaps")
    rows = B * n_out * 5 * h * w
    kc, n_chunks, ws, operand = grid_dtaps_scratch(dt, B, h, w, cin, n_sets * cout, 4, n_out, dev)
    dtaps = [torch.empty((7, cin, cout), dtype=torch.float32, device=dev) for _ in range(n_sets)]
    gsum_ws, gsums = _gsum_outputs(rows, n_sets, cout, dev) if emit_gsum else (None, [None])
    table = device_table("phase", h, w, corner_mode, dev)
    mul, add = act if act is not None else (None, None)
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    with torch.cuda.device(dev):
        err = build.library().gn_phase_conv_dtaps(
            build.ptr_array(phases), build.ptr(mul), build.ptr(add), gp, yp, gs0, gs1,
            table.data_ptr(), ws.data_ptr(), *_pair(dtaps), build.ptr(operand),
            build.ptr(gsum_ws), *_pair(gsums), B, h, w, cin, cout, n_sets, out_phases[0], n_out,
            kc, n_chunks, build.GSUM_ROWS, int(corner_mode == "zeros"), build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("phase_conv_dtaps", err)
    build.LAUNCHES["phase_conv_dtaps"] += 1
    return (tuple(dtaps), gsums) if emit_gsum else tuple(dtaps)


def phase_conv_bwd_plain(raw_phases, g_groups, y_groups, gs_list, tap_sets, corner_mode,
                         out_phases, act, with_stats, out_dtype):
    """Plain version of ``phase_conv_bwd``: ``phase_conv_dx_plain`` and
    ``phase_conv_dtaps_plain`` over one shared fold."""
    g_groups = _fold_groups(g_groups, y_groups if with_stats else None, gs_list)
    cin = raw_phases[0].shape[-1]
    dphases, dmul, dadd, _ = phase_conv_dx_plain(g_groups, tap_sets, corner_mode, out_phases, cin,
                                                 out_dtype, act, raw_phases)
    dtaps, gsums = phase_conv_dtaps_plain(raw_phases, g_groups, [t.shape for t, _ in tap_sets],
                                          corner_mode, out_phases, act, emit_gsum=True)
    return dphases, list(dtaps), gsums, dmul, dadd


def phase_conv_bwd(raw_phases, g_groups, y_groups, gs_list, tap_sets, corner_mode, out_phases,
                   act, with_stats, out_dtype):
    """The merged phase-conv backward (the Pallas ``_phase_conv_bwd``): dx,
    dtaps and Σg_eff of one conv in one launch.

    raw_phases: the forward's 4 RAW input phases (B, 5, h, w, C_in); g_groups:
    per tap set, the cotangents of its ``out_phases`` outputs; with
    ``with_stats``, y_groups / gs_list switch on the fold g_eff = g + gs0 +
    2·gs1·y; tap_sets: (taps, bias) as in the forward (bias is not read);
    act: the forward's prologue, which makes dx the raw input's cotangent
    and adds d_mul, d_add; out_dtype: the activation dtype. Returns (4
    dphases in out_dtype, per-set float32 dtaps (7, C_in, C_out), per-set
    float32 Σg_eff (C_out,), d_mul, d_add (float32 (C_in,), or None without
    act)). In bf16 the split route's passes over one folded cotangent
    (``phase_conv_dx``'s cotangent operand and ``grid_operand``'s
    act-applied input, with their scratch), one launch of both tensor-core
    GEMMs, then the sums: the outputs equal ``phase_conv_dx`` +
    ``phase_conv_dtaps`` (``emit_gsum``) bit for bit. In float32 one launch
    of the SIMT tiles of both roles, then the sums."""
    out_phases = _check_out_phases(out_phases, "phase_conv_bwd")
    x0 = raw_phases[0]
    if not on_cuda(x0, "phase_conv_bwd"):
        return phase_conv_bwd_plain(raw_phases, g_groups, y_groups, gs_list, tap_sets,
                                    corner_mode, out_phases, act, with_stats, out_dtype)
    B, _, h, w, cin = x0.shape
    grid_level(h, w)
    dev, dt = x0.device, x0.dtype
    if out_dtype != dt:
        raise TypeError(f"phase_conv_bwd: out_dtype {out_dtype} is not the input's {dt}")
    n_sets, n_out = len(tap_sets), len(out_phases)
    if len(raw_phases) != 4 or len(g_groups) != n_sets or any(len(g) != n_out for g in g_groups):
        raise ValueError("phase_conv_bwd: 4 phases, one cotangent per tap set and output phase")
    for i, p in enumerate(raw_phases):
        expect(p, (B, 5, h, w, cin), dt, dev, f"phase_conv_bwd phase {i}")
    cout = _check_sets(tap_sets, cin, dt, dev, "phase_conv_bwd")
    if not with_stats:
        y_groups = gs_list = None
    _check_cotangents(g_groups, y_groups, gs_list, (B, 5, h, w, cout), dt, dev,
                      "phase_conv_bwd")
    check_act(act, cin, dev, "phase_conv_bwd")
    rows = B * n_out * 5 * h * w
    dphases = [torch.empty((B, 5, h, w, cin), dtype=dt, device=dev) for _ in range(4)]
    tables, n_comb = dx_tables("phase", dt, h, w, corner_mode, dev, out_phases)
    red, operand, wpack, _ = dx_scratch(dt, B, h, w, cin, n_sets, cout, n_out, n_comb,
                                        act is not None, False, dev)
    if dt == torch.bfloat16:
        kc, n_chunks, ws, grid_op = grid_dtaps_scratch(dt, B, h, w, cin, n_sets * cout, 4, n_out,
                                                       dev)
        gpart = build.scratch(-(-rows // build.GSUM_ROWS) * n_sets * cout, dev)
    else:
        grid_op = None
        kc, n_chunks, ws, gpart = build.merged_scratch(rows, cin, n_sets * cout, dev)
    table = device_table("phase", h, w, corner_mode, dev)
    mul, add = act if act is not None else (None, None)
    dmul = dadd = None
    if act is not None:
        dmul, dadd = (torch.empty(cin, dtype=torch.float32, device=dev) for _ in range(2))
    dtaps = [torch.empty((7, cin, cout), dtype=torch.float32, device=dev) for _ in range(n_sets)]
    gsums = [torch.empty(cout, dtype=torch.float32, device=dev) for _ in range(n_sets)]
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    with torch.cuda.device(dev):
        err = build.library().gn_phase_conv_bwd(
            build.ptr_array(raw_phases), build.ptr(mul), build.ptr(add), gp, yp, gs0, gs1,
            *_pair([t for t, _ in tap_sets]), build.ptr_array(dphases), *map(build.ptr, tables),
            table.data_ptr(), build.ptr(red), build.ptr(dmul), build.ptr(dadd), ws.data_ptr(),
            *_pair(dtaps), gpart.data_ptr(), *_pair(gsums), build.ptr(operand), build.ptr(wpack),
            build.ptr(grid_op), B, h, w, cin, cout, n_sets, out_phases[0], n_out, kc, n_chunks,
            n_comb, build.GSUM_ROWS, int(corner_mode == "zeros"), build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("phase_conv_bwd", err)
    build.LAUNCHES["phase_conv_bwd"] += 1
    return tuple(dphases), dtaps, gsums, dmul, dadd


# --------------------------------------------------------------------------
# the stats fold outside the conv kernels (kernel l)
# --------------------------------------------------------------------------


def stats_geff(g_group, y_group, gs):
    """The stats-cotangent fold g_eff = g + gs0 + 2·gs1·y over a group of
    1-4 phase tensors in one launch (the Pallas ``_stats_geff``): float32
    math, rounded to g's dtype. g_group, y_group: contiguous tensors of one
    shape (B, 5, h, w, C) and dtype; gs: float32 (2, C). Returns the tuple
    of g_eff."""
    g0 = g_group[0]
    if not on_cuda(g0, "stats_geff"):
        return geff_plain(g_group, y_group, gs)
    n, shape, dev, dt = len(g_group), tuple(g0.shape), g0.device, g0.dtype
    if not 1 <= n <= 4 or len(y_group) != n:
        raise ValueError(f"stats_geff: takes 1-4 (g, y) pairs, got {n} and {len(y_group)}")
    for i, (g, y) in enumerate(zip(g_group, y_group)):
        expect(g, shape, dt, dev, f"stats_geff g {i}")
        expect(y, shape, dt, dev, f"stats_geff y {i}")
    expect(gs, (2, shape[-1]), torch.float32, dev, "stats_geff gs")
    outs = [torch.empty_like(g) for g in g_group]
    with torch.cuda.device(dev):
        err = build.library().gn_stats_geff(
            build.ptr_array(g_group), build.ptr_array(y_group), gs.data_ptr(),
            build.ptr_array(outs), n, g0.numel(), shape[-1], build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("stats_geff", err)
    build.LAUNCHES["stats_geff"] += 1
    return tuple(outs)


# --------------------------------------------------------------------------
# the phase chain's stride-2 conv (fused_dual_s2_conv_split, kernel m)
# --------------------------------------------------------------------------


def _merge_groups(groups):
    return None if groups is None else [(phase_merge(tuple(g)),) for g in groups]


def ds2s_fwd_plain(phases, tap_sets, corner_mode="average", act=None, with_stats=False):
    """Plain version: ``phase_conv_fwd_plain`` with output phase 2, then
    ``phase_split`` of each output."""
    r = phase_conv_fwd_plain(phases, tap_sets, corner_mode, (2,), act, with_stats)
    sets, stats = r if with_stats else (r, None)
    sets = [tuple(p.contiguous() for p in phase_split(y)) for (y,) in sets]
    return (sets, stats) if with_stats else sets


def _check_split(h, w, name):
    if h < 2 or h % 2:
        raise ValueError(f"{name}: the output grid ({h}, {w}) has no parity phases "
                         "(level s-1 >= 1 needed)")


def ds2s_fwd(phases, tap_sets, corner_mode: str = "average", act=None, with_stats: bool = False):
    """Both stride-2 convs of a DownBlock with their outputs as the 4 parity
    phases of the level-(s-1) grid (the Pallas ``_ds2s``).

    phases, tap_sets, act, with_stats: as ``phase_conv_fwd`` with out_phases
    (2,). Returns, per tap set, a 4-tuple of (B, 5, h/2, w/2, C_out) phases
    (the ``phase_split`` of its (B, 5, h, w, C_out) output); with
    ``with_stats`` also the per-set (2, C_out) [Σy, Σy²]. In bf16
    ``phase_conv_fwd``'s path at output phase 2 (``fwd_scratch``: the operand
    pass, the taps packed, the tensor-core GEMM, the stats' sum) with the
    split store in the GEMM's epilogue; in float32 the SIMT GEMM with the
    split store. Either way the outputs and stats equal ``phase_conv_fwd``
    (2,) followed by ``phase_split`` bit for bit."""
    if len(phases) != 4:
        raise ValueError(f"ds2s_fwd: takes 4 phases, got {len(phases)}")
    x0 = phases[0]
    if not on_cuda(x0, "ds2s_fwd"):
        return ds2s_fwd_plain(phases, tap_sets, corner_mode, act, with_stats)
    B, _, h, w, cin = x0.shape
    grid_level(h, w)
    _check_split(h, w, "ds2s_fwd")
    dev, dt = x0.device, x0.dtype
    for i, p in enumerate(phases):
        expect(p, (B, 5, h, w, cin), dt, dev, f"ds2s_fwd phase {i}")
    cout = _check_sets(tap_sets, cin, dt, dev, "ds2s_fwd")
    check_act(act, cin, dev, "ds2s_fwd")
    n_sets = len(tap_sets)
    outs = [torch.empty((B, 5, h // 2, w // 2, cout), dtype=dt, device=dev)
            for _ in range(4 * n_sets)]
    table = device_table("phase", h, w, corner_mode, dev)
    mul, add = act if act is not None else (None, None)
    stats, ws, operand, wpack = fwd_scratch(dt, B, h, w, cin, n_sets, cout, 4, 1, with_stats,
                                            dev)
    with torch.cuda.device(dev):
        err = build.library().gn_ds2s_fwd(
            *[p.data_ptr() for p in phases], build.ptr(mul), build.ptr(add),
            *_set_ptrs(tap_sets), build.ptr_array(outs), table.data_ptr(), build.ptr(ws),
            *_pair(stats), build.ptr(operand), build.ptr(wpack), B, h, w, cin, cout, n_sets,
            int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("ds2s_fwd", err)
    build.LAUNCHES["ds2s_fwd"] += 1
    sets = [tuple(outs[4 * i : 4 * (i + 1)]) for i in range(n_sets)]
    return (sets, stats) if with_stats else sets


def ds2s_dx_plain(g_groups, tap_sets, corner_mode, cin, dtype, act=None, raw_phases=None,
                  y_groups=None, gs_list=None):
    """Plain version of ``ds2s_dx``: ``phase_conv_dx_plain`` with output
    phase 2 on the ``phase_merge``d cotangents (and outputs)."""
    return phase_conv_dx_plain(_merge_groups(g_groups), tap_sets, corner_mode, (2,), cin,
                               dtype, act, raw_phases, _merge_groups(y_groups), gs_list)


def _check_split_cotangents(g_groups, y_groups, gs_list, shape, dt, dev, n_sets, name):
    if len(g_groups) != n_sets or any(len(g) != 4 for g in g_groups):
        raise ValueError(f"{name}: 4 cotangent phases per tap set")
    if y_groups is not None and (len(y_groups) != n_sets or any(len(y) != 4 for y in y_groups)):
        raise ValueError(f"{name}: 4 output phases per tap set")
    _check_cotangents(g_groups, y_groups, gs_list, shape, dt, dev, name)


def ds2s_dx(g_groups, tap_sets, corner_mode, cin, dtype, act=None, raw_phases=None,
            y_groups=None, gs_list=None):
    """Input cotangent of ``ds2s_fwd`` (the dx kernel of ``_ds2s_bwd``).

    g_groups: per tap set, the 4 cotangent phases (B, 5, h/2, w/2, C_out) of
    its output in ``dtype``; the rest as ``phase_conv_dx`` (y_groups: the
    forward's output phases). Returns (4 dphases (B, 5, h, w, C_in), d_mul,
    d_add, gsums). In bf16 ``phase_conv_dx``'s path at output phase 2, its
    cotangent pass reading row m of the merged cotangent from its parity
    phase (``dx_tables``, ``dx_scratch``), so the outputs equal
    ``phase_conv_dx`` on the ``phase_merge``d cotangents bit for bit; in
    float32 the SIMT gather-GEMM with the split loader."""
    g0 = g_groups[0][0]
    if not on_cuda(g0, "ds2s_dx"):
        return ds2s_dx_plain(g_groups, tap_sets, corner_mode, cin, dtype, act, raw_phases,
                             y_groups, gs_list)
    B, _, hp, wp, cout = g0.shape
    h, w = 2 * hp, 2 * wp
    grid_level(h, w)
    dev, n_sets = g0.device, len(tap_sets)
    _check_split_cotangents(g_groups, y_groups, gs_list, (B, 5, hp, wp, cout), dtype, dev,
                            n_sets, "ds2s_dx")
    _check_sets(tap_sets, cin, dtype, dev, "ds2s_dx")
    check_act(act, cin, dev, "ds2s_dx")
    if act is not None:
        for i, x in enumerate(raw_phases):
            expect(x, (B, 5, h, w, cin), dtype, dev, f"ds2s_dx raw phase {i}")
    outs = [torch.empty((B, 5, h, w, cin), dtype=dtype, device=dev) for _ in range(4)]
    tables, n_comb = dx_tables("phase", dtype, h, w, corner_mode, dev, (2,))
    red, operand, wpack, _ = dx_scratch(dtype, B, h, w, cin, n_sets, cout, 1, n_comb,
                                        act is not None, False, dev)
    mul, add = act if act is not None else (None, None)
    dmul = dadd = None
    if act is not None:
        dmul, dadd = (torch.empty(cin, dtype=torch.float32, device=dev) for _ in range(2))
    gsum_ws, gsums = (None, [None])
    if y_groups is not None:
        gsum_ws, gsums = _gsum_outputs(B * 5 * h * w, n_sets, cout, dev)
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    raws = build.ptr_array(raw_phases) if act is not None else None
    with torch.cuda.device(dev):
        err = build.library().gn_ds2s_dx(
            gp, yp, gs0, gs1, *_pair([t for t, _ in tap_sets]), raws, build.ptr(mul),
            build.ptr(add), build.ptr_array(outs), *map(build.ptr, tables), build.ptr(operand),
            build.ptr(wpack), build.ptr(red), build.ptr(dmul), build.ptr(dadd),
            build.ptr(gsum_ws), *_pair(gsums), B, h, w, cin, cout, n_sets, n_comb,
            build.GSUM_ROWS, build.dtype_code(dtype), build.stream_ptr(dev),
        )
    build.check("ds2s_dx", err)
    build.LAUNCHES["ds2s_dx"] += 1
    return tuple(outs), dmul, dadd, (gsums if y_groups is not None else None)


def ds2s_dtaps_plain(phases, g_groups, tap_shapes, corner_mode, act=None, y_groups=None,
                     gs_list=None, emit_gsum=False):
    """Plain version of ``ds2s_dtaps``: ``phase_conv_dtaps_plain`` with
    output phase 2 on the ``phase_merge``d cotangents (and outputs)."""
    return phase_conv_dtaps_plain(phases, _merge_groups(g_groups), tap_shapes, corner_mode, (2,),
                                  act, _merge_groups(y_groups), gs_list, emit_gsum)


def ds2s_dtaps(phases, g_groups, tap_shapes, corner_mode, act=None, y_groups=None, gs_list=None,
               emit_gsum=False):
    """Tap cotangents of ``ds2s_fwd`` summed over the batch (the dtaps kernel
    of ``_ds2s_bwd``): per set a float32 (7, C_in, C_out); with ``emit_gsum``
    also the per-set Σg_eff. phases: the forward's 4 RAW input phases;
    g_groups, y_groups, gs_list: as ``ds2s_dx``. In bf16 ``phase_conv_dtaps``'
    operand pass and tensor-core GEMM at output phase 2, its cotangent rows
    read from the 4 phases (``grid_dtaps_scratch``); in float32 the SIMT
    GEMM."""
    x0 = phases[0]
    if not on_cuda(x0, "ds2s_dtaps"):
        return ds2s_dtaps_plain(phases, g_groups, tap_shapes, corner_mode, act, y_groups,
                                gs_list, emit_gsum)
    B, _, h, w, cin = x0.shape
    grid_level(h, w)
    _check_split(h, w, "ds2s_dtaps")
    dev, dt = x0.device, x0.dtype
    n_sets = len(g_groups)
    cout = tap_shapes[0][-1]
    if any(tuple(s) != (7, cin, cout) for s in tap_shapes) or not 1 <= n_sets <= 2:
        raise ValueError(f"ds2s_dtaps: tap shapes {tap_shapes} for C_in {cin}")
    for i, p in enumerate(phases):
        expect(p, (B, 5, h, w, cin), dt, dev, f"ds2s_dtaps phase {i}")
    _check_split_cotangents(g_groups, y_groups, gs_list, (B, 5, h // 2, w // 2, cout), dt, dev,
                            n_sets, "ds2s_dtaps")
    check_act(act, cin, dev, "ds2s_dtaps")
    rows = B * 5 * h * w
    kc, n_chunks, ws, operand = grid_dtaps_scratch(dt, B, h, w, cin, n_sets * cout, 4, 1, dev)
    dtaps = [torch.empty((7, cin, cout), dtype=torch.float32, device=dev) for _ in range(n_sets)]
    gsum_ws, gsums = _gsum_outputs(rows, n_sets, cout, dev) if emit_gsum else (None, [None])
    table = device_table("phase", h, w, corner_mode, dev)
    mul, add = act if act is not None else (None, None)
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    with torch.cuda.device(dev):
        err = build.library().gn_ds2s_dtaps(
            build.ptr_array(phases), build.ptr(mul), build.ptr(add), gp, yp, gs0, gs1,
            table.data_ptr(), ws.data_ptr(), *_pair(dtaps), build.ptr(operand),
            build.ptr(gsum_ws), *_pair(gsums), B, h, w, cin, cout, n_sets, kc, n_chunks,
            build.GSUM_ROWS, int(corner_mode == "zeros"), build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("ds2s_dtaps", err)
    build.LAUNCHES["ds2s_dtaps"] += 1
    return (tuple(dtaps), gsums) if emit_gsum else tuple(dtaps)


# --------------------------------------------------------------------------
# upsample + dual conv (fused_up_dual_conv)
# --------------------------------------------------------------------------


def _up_phases(x, corner_mode):
    """The four level-(s+1) phases the up conv reads (``ico_pad`` then the
    midpoints), in x's dtype."""
    return phase_upsample(ico_pad(x, grid_level(x.shape[2], x.shape[3]), corner_mode))


def up_dual_conv_fwd_plain(x, tap_sets, corner_mode="average", with_stats=False):
    """Plain version: ``ico_pad`` at level s, the midpoint phases of level
    s+1 (``phase_upsample``), then ``phase_conv`` (all 4 phases) per set."""
    phases = _up_phases(x, corner_mode)
    sets = [phase_conv(phases, taps, bias, corner_mode) for taps, bias in tap_sets]
    return (sets, [stats_plain(o) for o in sets]) if with_stats else sets


def _phase_outputs(n, shape, dt, dev):
    """n output phases of one shape as views of one allocation: one
    allocator call where n would cost n of the wrapper's host time (autograd
    forbids modifying such views in place, and no caller does)."""
    return torch.empty((n, *shape), dtype=dt, device=dev).unbind(0)


def up_dual_conv_fwd(x, tap_sets, corner_mode: str = "average", with_stats: bool = False):
    """An UpBlock's upsample s -> s+1 and first convs, fused.

    x: contiguous (B, 5, h, w, C_in) level-s grid, float32 or bfloat16;
    tap_sets: 1 or 2 (taps, bias) as for ``phase_conv_fwd``.
    Returns, per tap set, the 4 level-(s+1) output phases (B, 5, h, w, C_out);
    with ``with_stats`` also the per-set (2, C_out) [Σy, Σy²]. In bf16 four
    kernels: the operand pass (``up_operand``), the taps packed side by side,
    the tensor-core GEMM and the stats' fixed-order sum; in float32 the SIMT
    GEMM and the sum.
    """
    if not on_cuda(x, "up_dual_conv_fwd"):
        return up_dual_conv_fwd_plain(x, tap_sets, corner_mode, with_stats)
    B, _, h, w, cin = x.shape
    grid_level(h, w)
    dev, dt = x.device, x.dtype
    expect(x, (B, 5, h, w, cin), dt, dev, "up_dual_conv_fwd x")
    cout = _check_sets(tap_sets, cin, dt, dev, "up_dual_conv_fwd")
    n_sets = len(tap_sets)
    outs = _phase_outputs(4 * n_sets, (B, 5, h, w, cout), dt, dev)
    conv_table = device_table("phase", h, w, corner_mode, dev)
    up_table = device_table("up", h, w, corner_mode, dev)
    stats, ws, operand, wpack = fwd_scratch(dt, B, h, w, cin, n_sets, cout, 4, 4, with_stats, dev)
    out_ptrs = build.ptr_array(outs)
    with torch.cuda.device(dev):
        err = build.library().gn_up_dual_conv_fwd(
            x.data_ptr(), *_set_ptrs(tap_sets), out_ptrs, conv_table.data_ptr(),
            up_table.data_ptr(), build.ptr(ws), *_pair(stats), build.ptr(operand),
            build.ptr(wpack), B, h, w, cin, cout, n_sets, int(corner_mode == "zeros"),
            build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_dual_conv_fwd", err)
    build.LAUNCHES["up_dual_conv_fwd"] += 1
    sets = [tuple(outs[i * 4 : (i + 1) * 4]) for i in range(n_sets)]
    return (sets, stats) if with_stats else sets


def _up_adjoint(g_groups, tap_sets, corner_mode):
    """The level-s dx of the up conv in float32: the conv, phase-pad,
    upsample and pad transposes, by autograd of the plain forward (linear in
    its input)."""
    B, _, h, w, _ = g_groups[0][0].shape
    cin = tap_sets[0][0].shape[1]
    with torch.enable_grad():
        leaf = torch.zeros((B, 5, h, w, cin), dtype=torch.float32, device=g_groups[0][0].device,
                           requires_grad=True)
        phases = _up_phases(leaf, corner_mode)
        outs, grads = [], []
        for (taps, _), group in zip(tap_sets, g_groups):
            outs += phase_conv(phases, taps.float(), None, corner_mode)
            grads += [g.float() for g in group]
        (dx,) = torch.autograd.grad(outs, [leaf], grads)
    return dx


def _gsums(g_groups):
    return [sum(g.float().sum(dim=(0, 1, 2, 3)) for g in group) for group in g_groups]


def up_dual_conv_dx_plain(g_groups, tap_sets, corner_mode, dtype, y_groups=None, gs_list=None,
                          emit_gsum=False):
    """Plain version of ``up_dual_conv_dx``: conv, phase-pad, upsample and
    pad transposes in float32, rounded once."""
    g_groups = _fold_groups(g_groups, y_groups, gs_list)
    dx = _up_adjoint(g_groups, tap_sets, corner_mode)
    return dx.to(dtype), (_gsums(g_groups) if emit_gsum else None)


def up_dual_conv_dx(g_groups, tap_sets, corner_mode, dtype, y_groups=None, gs_list=None,
                    emit_gsum=False):
    """Input cotangent of the up conv (``_upd_bwd``'s dx kernel): the level-s
    (B, 5, h, w, C_in) dx in ``dtype``, and with ``emit_gsum`` the per-set
    Σg_eff. Arguments as for ``phase_conv_dx`` (4 phases per set). In bf16
    the stride-1 phase conv's tensor-core dx GEMM over the 4 upsampled
    phases into float32 dU (``dx_scratch``), then the upsample and level-s
    pad adjoint (``halo.up_adjoint_table``), rounded once; in float32 the
    SIMT gather-GEMM over the composed ``halo.up_dx_table``."""
    g0 = g_groups[0][0]
    if not on_cuda(g0, "up_dual_conv_dx"):
        return up_dual_conv_dx_plain(g_groups, tap_sets, corner_mode, dtype, y_groups, gs_list,
                                     emit_gsum)
    B, _, h, w, cout = g0.shape
    grid_level(h, w)
    dev, n_sets = g0.device, len(tap_sets)
    cin = tap_sets[0][0].shape[1]
    if len(g_groups) != n_sets or any(len(g) != 4 for g in g_groups):
        raise ValueError("up_dual_conv_dx: 4 cotangent phases per tap set")
    _check_cotangents(g_groups, y_groups, gs_list, (B, 5, h, w, cout), dtype, dev,
                      "up_dual_conv_dx")
    _check_sets(tap_sets, cin, dtype, dev, "up_dual_conv_dx")
    dx = torch.empty((B, 5, h, w, cin), dtype=dtype, device=dev)
    tables, n_comb = dx_tables("up", dtype, h, w, corner_mode, dev)
    _, operand, wpack, du = dx_scratch(dtype, B, h, w, cin, n_sets, cout, 4, n_comb, False,
                                       True, dev)
    adjoint = ((None,) * 3 if dtype != torch.bfloat16
               else device_dx_table("up_adjoint", h, w, corner_mode, dev))
    gsum_ws, gsums = (_gsum_outputs(B * 4 * 5 * h * w, n_sets, cout, dev) if emit_gsum
                      else (None, [None]))
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    with torch.cuda.device(dev):
        err = build.library().gn_up_dual_conv_dx(
            gp, yp, gs0, gs1, *_pair([t for t, _ in tap_sets]), dx.data_ptr(),
            *map(build.ptr, tables), *map(build.ptr, adjoint), build.ptr(operand),
            build.ptr(wpack), build.ptr(du), build.ptr(gsum_ws), *_pair(gsums),
            B, h, w, cin, cout, n_sets, n_comb, build.GSUM_ROWS, build.dtype_code(dtype),
            build.stream_ptr(dev),
        )
    build.check("up_dual_conv_dx", err)
    build.LAUNCHES["up_dual_conv_dx"] += 1
    return dx, (gsums if emit_gsum else None)


def operand_rows(B, h, w):
    """Rows of the up conv's operand: per sample the 4·5hw upsampled cells
    and the 2 level-(s+1) poles, then one zero row."""
    return B * (4 * 5 * h * w + 2) + 1


def up_operand_plain(x, corner_mode="average"):
    """Plain version of ``up_operand``: ``_up_phases`` stacked phase by phase,
    each sample's phase-pad poles (``chart_mean`` of phase ee's cell (0, 0)
    and phase oq's last cell; zeros under ``"zeros"``), a zero row, and the
    channels padded with zeros to ``build.operand_width``."""
    B, _, h, w, cin = x.shape
    phases = _up_phases(x, corner_mode)
    cells = torch.stack(phases, dim=1).reshape(B, 4 * 5 * h * w, cin)
    if corner_mode == "average":
        poles = torch.stack([chart_mean(phases[0][:, :, 0, 0]),
                             chart_mean(phases[3][:, :, h - 1, w - 1])], dim=1)
    else:
        poles = x.new_zeros((B, 2, cin))
    rows = torch.cat([torch.cat([cells, poles], dim=1).reshape(-1, cin), x.new_zeros((1, cin))])
    return torch.nn.functional.pad(rows, (0, build.operand_width(cin) - cin))


def up_operand(x, corner_mode: str = "average"):
    """The upsampled level-(s+1) operand of the up conv, as the bf16 dtaps
    builds it before its GEMM: x, a contiguous (B, 5, h, w, C_in) level-s grid
    (float32 or bfloat16) -> (B·(4·5hw + 2) + 1, C_in rounded up to 8) in x's
    dtype (``up_operand_plain`` says which row is which)."""
    if not on_cuda(x, "up_operand"):
        return up_operand_plain(x, corner_mode)
    B, _, h, w, cin = x.shape
    grid_level(h, w)
    dev, dt = x.device, x.dtype
    expect(x, (B, 5, h, w, cin), dt, dev, "up_operand x")
    out = torch.empty((operand_rows(B, h, w), build.operand_width(cin)), dtype=dt, device=dev)
    up_table = device_table("up", h, w, corner_mode, dev)
    with torch.cuda.device(dev):
        err = build.library().gn_up_operand(
            x.data_ptr(), up_table.data_ptr(), out.data_ptr(), B, h, w, cin,
            int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_operand", err)
    build.LAUNCHES["up_operand"] += 1
    return out


def _up_dtaps_scratch(dt, B, h, w, cin, n_sets, cout, dev):
    """(kc, n_chunks, partials, operand) of the up conv's dtaps over B·4·5hw
    rows: float32 the SIMT GEMM's split and no operand; bf16 the tensor-core
    GEMM's split and the operand scratch of its first pass."""
    rows = B * 4 * 5 * h * w
    if dt == torch.bfloat16:
        kc, n_chunks = build.mma_dtaps_split(rows, build.mma_dtaps_blocks(cin, n_sets * cout))
        operand = torch.empty((operand_rows(B, h, w), build.operand_width(cin)), dtype=dt,
                              device=dev)
    else:
        kc, n_chunks = build.dtaps_split(rows,
                                         build.n_tiles(7 * cin) * build.n_tiles(n_sets * cout))
        operand = None
    return kc, n_chunks, build.scratch(n_chunks * 7 * cin * n_sets * cout, dev), operand


def up_dual_conv_dtaps_plain(x, g_groups, corner_mode, y_groups=None, gs_list=None):
    """Plain version of ``up_dual_conv_dtaps``."""
    g_groups = _fold_groups(g_groups, y_groups, gs_list)
    cin, cout = x.shape[-1], g_groups[0][0].shape[-1]
    with torch.enable_grad():
        return tuple(_dtaps_by_autograd(_up_phases(x, corner_mode), g_groups,
                                        [(7, cin, cout)] * len(g_groups), corner_mode, _ALL))


def up_dual_conv_dtaps(x, g_groups, corner_mode, y_groups=None, gs_list=None):
    """Tap cotangents of the up conv summed over the batch (``_upd_bwd``'s
    dtaps kernel): per set a float32 (7, C_in, C_out). In bf16 two kernels
    and the fixed-order sum: the operand pass (``up_operand``) and the
    tensor-core GEMM over its rows; in float32 the SIMT GEMM."""
    if not on_cuda(x, "up_dual_conv_dtaps"):
        return up_dual_conv_dtaps_plain(x, g_groups, corner_mode, y_groups, gs_list)
    B, _, h, w, cin = x.shape
    grid_level(h, w)
    dev, dt = x.device, x.dtype
    expect(x, (B, 5, h, w, cin), dt, dev, "up_dual_conv_dtaps x")
    n_sets = len(g_groups)
    cout = g_groups[0][0].shape[-1]
    if not 1 <= n_sets <= 2 or any(len(g) != 4 for g in g_groups):
        raise ValueError("up_dual_conv_dtaps: 1 or 2 sets of 4 cotangent phases")
    _check_cotangents(g_groups, y_groups, gs_list, (B, 5, h, w, cout), dt, dev,
                      "up_dual_conv_dtaps")
    kc, n_chunks, ws, operand = _up_dtaps_scratch(dt, B, h, w, cin, n_sets, cout, dev)
    dtaps = [torch.empty((7, cin, cout), dtype=torch.float32, device=dev) for _ in range(n_sets)]
    conv_table = device_table("phase", h, w, corner_mode, dev)
    up_table = device_table("up", h, w, corner_mode, dev)
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    with torch.cuda.device(dev):
        err = build.library().gn_up_dual_conv_dtaps(
            x.data_ptr(), gp, yp, gs0, gs1, conv_table.data_ptr(), up_table.data_ptr(),
            ws.data_ptr(), *_pair(dtaps), build.ptr(operand), B, h, w, cin, cout, n_sets, kc,
            n_chunks, int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_dual_conv_dtaps", err)
    build.LAUNCHES["up_dual_conv_dtaps"] += 1
    return tuple(dtaps)


def up_dual_conv_bwd_plain(x, g_groups, tap_sets, corner_mode, y_groups=None, gs_list=None):
    """Plain version of ``up_dual_conv_bwd``: ``up_dual_conv_dx_plain`` and
    ``up_dual_conv_dtaps_plain`` over one shared fold."""
    g_groups = _fold_groups(g_groups, y_groups, gs_list)
    dx, gsums = up_dual_conv_dx_plain(g_groups, tap_sets, corner_mode, x.dtype, emit_gsum=True)
    dta, dtb = up_dual_conv_dtaps_plain(x, g_groups, corner_mode)
    return dx, dta, dtb, *gsums


def up_dual_conv_bwd(x, g_groups, tap_sets, corner_mode, y_groups=None, gs_list=None):
    """The merged up-conv backward (``_upd_bwd``'s merged branch): dx, both
    sets' dtaps and Σg_eff over one read of the cotangents.

    x: the forward's (B, 5, h, w, C_in) level-s grid; g_groups: the two tap
    sets' 4 level-(s+1) phase cotangents (B, 5, h, w, C_out) in x's dtype;
    tap_sets: the two (taps, bias) (bias is not read); y_groups / gs_list
    switch on the fold. Returns (dx in x's dtype, dtaps_a, dtaps_b float32
    (7, C_in, C_out), Σg_eff a, Σg_eff b float32 (C_out,)). In bf16 the
    split route's passes over one folded cotangent (``up_dual_conv_dx``'s
    cotangent operand, ``up_operand``'s upsampled operand, with their
    scratch), one launch of both tensor-core GEMMs, then the upsample
    adjoint and the sums: the outputs equal ``up_dual_conv_dx`` +
    ``up_dual_conv_dtaps`` bit for bit. In float32 one launch of the SIMT
    tiles of both roles, then the sums."""
    if not on_cuda(x, "up_dual_conv_bwd"):
        return up_dual_conv_bwd_plain(x, g_groups, tap_sets, corner_mode, y_groups, gs_list)
    B, _, h, w, cin = x.shape
    grid_level(h, w)
    dev, dt = x.device, x.dtype
    expect(x, (B, 5, h, w, cin), dt, dev, "up_dual_conv_bwd x")
    if len(tap_sets) != 2 or len(g_groups) != 2 or any(len(g) != 4 for g in g_groups):
        raise ValueError("up_dual_conv_bwd: 2 tap sets, each with 4 cotangent phases")
    cout = _check_sets(tap_sets, cin, dt, dev, "up_dual_conv_bwd")
    _check_cotangents(g_groups, y_groups, gs_list, (B, 5, h, w, cout), dt, dev,
                      "up_dual_conv_bwd")
    dx = torch.empty((B, 5, h, w, cin), dtype=dt, device=dev)
    rows = B * 4 * 5 * h * w
    tables, n_comb = dx_tables("up", dt, h, w, corner_mode, dev)
    _, operand, wpack, du = dx_scratch(dt, B, h, w, cin, 2, cout, 4, n_comb, False, True, dev)
    conv_table = device_table("phase", h, w, corner_mode, dev)
    up_table = device_table("up", h, w, corner_mode, dev)
    if dt == torch.bfloat16:
        adjoint = device_dx_table("up_adjoint", h, w, corner_mode, dev)
        kc, n_chunks, ws, up_operand = _up_dtaps_scratch(dt, B, h, w, cin, 2, cout, dev)
        gpart = build.scratch(-(-rows // build.GSUM_ROWS) * 2 * cout, dev)
    else:
        adjoint, up_operand = (None,) * 3, None
        kc, n_chunks, ws, gpart = build.merged_scratch(rows, cin, 2 * cout, dev)
    dtaps = [torch.empty((7, cin, cout), dtype=torch.float32, device=dev) for _ in range(2)]
    gsums = [torch.empty(cout, dtype=torch.float32, device=dev) for _ in range(2)]
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    with torch.cuda.device(dev):
        err = build.library().gn_up_dual_conv_bwd(
            x.data_ptr(), gp, yp, gs0, gs1, *_pair([t for t, _ in tap_sets]), dx.data_ptr(),
            *map(build.ptr, tables), *map(build.ptr, adjoint), conv_table.data_ptr(),
            up_table.data_ptr(), ws.data_ptr(), *_pair(dtaps), gpart.data_ptr(), *_pair(gsums),
            build.ptr(operand), build.ptr(wpack), build.ptr(du), build.ptr(up_operand),
            B, h, w, cin, cout, 2, kc, n_chunks, n_comb, build.GSUM_ROWS,
            int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_dual_conv_bwd", err)
    build.LAUNCHES["up_dual_conv_bwd"] += 1
    return dx, *dtaps, *gsums


# --------------------------------------------------------------------------
# the decoder's phase chain: upsample + dual conv of a joined pair
# (fused_up_dual_conv_pair, kernel n)
# --------------------------------------------------------------------------


def pair_join(a, b, affines):
    """The residual join relu(a·mul1 + add1 + b·mul2 + add2) of one phase in
    float32, cast to a's dtype; affines = (mul1, add1, mul2, add2)."""
    mul1, add1, mul2, add2 = affines
    return torch.clamp_min(a.float() * mul1 + add1 + b.float() * mul2 + add2, 0.0).to(a.dtype)


def _pair_grid(b0, y10, affines):
    """The level-s grid the pair joins into: the join per phase, interleaved."""
    return phase_merge(tuple(pair_join(a, b, affines) for a, b in zip(b0, y10))).contiguous()


def _check_pair(b0, y10, affines, name):
    """Shapes and types of a pair and its affines; returns (B, h, w, C) of
    the level-s grid (twice the phases' sides)."""
    if len(b0) != 4 or len(y10) != 4 or len(affines) != 4:
        raise ValueError(f"{name}: takes 4 + 4 phases and 4 affines")
    x0 = b0[0]
    B, _, hp, wp, cin = x0.shape
    h, w = 2 * hp, 2 * wp
    grid_level(h, w)
    dev, dt = x0.device, x0.dtype
    for i, p in enumerate((*b0, *y10)):
        expect(p, (B, 5, hp, wp, cin), dt, dev, f"{name} phase {i}")
    for a in affines:
        expect(a, (cin,), torch.float32, dev, f"{name} affine")
    return B, h, w, cin


def up_pair_fwd_plain(b0, y10, affines, tap_sets, corner_mode="average", with_stats=False):
    """Plain version: the join per phase, ``phase_merge``, then
    ``up_dual_conv_fwd_plain``."""
    return up_dual_conv_fwd_plain(_pair_grid(b0, y10, affines), tap_sets, corner_mode, with_stats)


def up_pair_fwd(b0, y10, affines, tap_sets, corner_mode: str = "average",
                with_stats: bool = False):
    """An UpBlock's upsample s -> s+1 and both first convs on the previous
    UpBlock's residual tail (the Pallas ``_updp``).

    b0, y10: 4-tuples of contiguous (B, 5, h/2, w/2, C_in) raw phases of the
    level-s grid (float32 or bfloat16); affines: float32 (mul1, add1, mul2,
    add2), each (C_in,), the pending bn01 / bn10 applies; tap_sets: 2
    (taps, bias) as for ``up_dual_conv_fwd``. Computes ``up_dual_conv_fwd``
    of the grid that relu(b0·mul1 + add1 + y10·mul2 + add2), cast to the
    dtype and interleaved, would be: in float32 the SIMT GEMM joins it on
    load and it is never written; in bf16 it is joined once into a level-s
    grid, and the up conv's operand pass and tensor-core GEMM run on it.
    Returns, per tap set, the 4 level-(s+1) phases (B, 5, h, w, C_out); with
    ``with_stats`` also the per-set (2, C_out) [Σy, Σy²]."""
    if not on_cuda(b0[0], "up_pair_fwd"):
        return up_pair_fwd_plain(b0, y10, affines, tap_sets, corner_mode, with_stats)
    B, h, w, cin = _check_pair(b0, y10, affines, "up_pair_fwd")
    dev, dt = b0[0].device, b0[0].dtype
    if len(tap_sets) != 2:
        raise ValueError(f"up_pair_fwd: takes 2 tap sets, got {len(tap_sets)}")
    cout = _check_sets(tap_sets, cin, dt, dev, "up_pair_fwd")
    outs = _phase_outputs(8, (B, 5, h, w, cout), dt, dev)
    conv_table = device_table("phase", h, w, corner_mode, dev)
    up_table = device_table("up", h, w, corner_mode, dev)
    stats, ws, operand, wpack = fwd_scratch(dt, B, h, w, cin, 2, cout, 4, 4, with_stats, dev)
    joined = torch.empty((B, 5, h, w, cin), dtype=dt, device=dev) if operand is not None else None
    with torch.cuda.device(dev):
        err = build.library().gn_up_pair_fwd(
            build.ptr_array((*b0, *y10)), build.ptr_array(affines), *_set_ptrs(tap_sets),
            build.ptr_array(outs), conv_table.data_ptr(), up_table.data_ptr(), build.ptr(ws),
            *_pair(stats), build.ptr(operand), build.ptr(joined), build.ptr(wpack), B, h, w,
            cin, cout, int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_pair_fwd", err)
    build.LAUNCHES["up_pair_fwd"] += 1
    sets = [tuple(outs[:4]), tuple(outs[4:])]
    return (sets, stats) if with_stats else sets


def up_pair_dx_plain(g_groups, b0, y10, affines, tap_sets, corner_mode, y_groups=None,
                     gs_list=None, emit_gsum=False):
    """Plain version of ``up_pair_dx``: the up conv's transposes in float32
    (not rounded), then the join's adjoint per phase, rounded once."""
    g_groups = _fold_groups(g_groups, y_groups, gs_list)
    dx = _up_adjoint(g_groups, tap_sets, corner_mode)
    mul1, add1, mul2, add2 = affines
    dt, dims = b0[0].dtype, (0, 1, 2, 3)
    db0, dy10, dmul1, dadd, dmul2 = [], [], 0.0, 0.0, 0.0
    for d, a, b in zip(phase_split(dx), b0, y10):
        a32, b32 = a.float(), b.float()
        dpre = d * (a32 * mul1 + add1 + b32 * mul2 + add2 > 0.0).float()
        db0.append((dpre * mul1).to(dt))
        dy10.append((dpre * mul2).to(dt))
        dmul1 = dmul1 + (dpre * a32).sum(dim=dims)
        dadd = dadd + dpre.sum(dim=dims)
        dmul2 = dmul2 + (dpre * b32).sum(dim=dims)
    return (tuple(db0), tuple(dy10), dmul1, dadd, dmul2, dadd,
            _gsums(g_groups) if emit_gsum else None)


def up_pair_dx(g_groups, b0, y10, affines, tap_sets, corner_mode, y_groups=None, gs_list=None,
               emit_gsum=False):
    """Input cotangents of ``up_pair_fwd`` (the dx kernel of ``_updp_bwd``).

    g_groups: the two tap sets' 4 level-(s+1) phase cotangents (B, 5, h, w,
    C_out) in the pair's dtype; b0, y10, affines: the forward's pair;
    tap_sets: (taps, bias) as in the forward (bias is not read); y_groups /
    gs_list switch on the fold, ``emit_gsum`` the per-set Σg_eff. The up
    conv's level-s dx stays float32 through the join's adjoint, dpre =
    dx·1{a·mul1 + add1 + b·mul2 + add2 > 0}. Returns (4 db0 = dpre·mul1, 4
    dy10 = dpre·mul2 phases in the dtype, d_mul1 = Σdpre·a, d_add1 = Σdpre,
    d_mul2 = Σdpre·b, d_add2 = d_add1 (float32 (C_in,)), gsums or None).
    In bf16 it is ``up_dual_conv_dx``'s route (the cotangent pass, the
    tensor-core GEMM into float32 dU, ``dx_scratch``) whose last pass gathers
    each level-s cell's dx through ``halo.up_adjoint_table`` and applies the
    join's adjoint before any rounding, with one partial row a
    ``build.PAIR_ADJOINT_ROWS`` cells; in float32 the SIMT gather-GEMM over
    the composed ``halo.up_dx_table`` with the adjoint in its epilogue."""
    if not on_cuda(b0[0], "up_pair_dx"):
        return up_pair_dx_plain(g_groups, b0, y10, affines, tap_sets, corner_mode, y_groups,
                                gs_list, emit_gsum)
    B, h, w, cin = _check_pair(b0, y10, affines, "up_pair_dx")
    dev, dt = b0[0].device, b0[0].dtype
    if len(tap_sets) != 2 or len(g_groups) != 2 or any(len(g) != 4 for g in g_groups):
        raise ValueError("up_pair_dx: 2 tap sets, each with 4 cotangent phases")
    cout = _check_sets(tap_sets, cin, dt, dev, "up_pair_dx")
    _check_cotangents(g_groups, y_groups, gs_list, (B, 5, h, w, cout), dt, dev, "up_pair_dx")
    M = 5 * h * w
    grads = [torch.empty_like(b0[0]) for _ in range(8)]
    tables, n_comb = dx_tables("up", dt, h, w, corner_mode, dev)
    _, operand, wpack, du = dx_scratch(dt, B, h, w, cin, 2, cout, 4, n_comb, False, True, dev)
    if dt == torch.bfloat16:
        adjoint = device_dx_table("up_adjoint", h, w, corner_mode, dev)
        red = build.scratch(build.pair_adjoint_blocks(B, h, w) * 3 * cin, dev)
    else:
        adjoint, red = (None,) * 3, build.scratch(B * build.n_tiles(M) * 3 * cin, dev)
    daff = [torch.empty(cin, dtype=torch.float32, device=dev) for _ in range(3)]
    gsum_ws, gsums = _gsum_outputs(B * 4 * M, 2, cout, dev) if emit_gsum else (None, [None])
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    with torch.cuda.device(dev):
        err = build.library().gn_up_pair_dx(
            gp, yp, gs0, gs1, *_pair([t for t, _ in tap_sets]), build.ptr_array((*b0, *y10)),
            build.ptr_array(affines), build.ptr_array(grads), *map(build.ptr, tables),
            *map(build.ptr, adjoint), build.ptr(operand), build.ptr(wpack), build.ptr(du),
            red.data_ptr(), build.ptr_array(daff), build.ptr(gsum_ws), *_pair(gsums), B, h, w,
            cin, cout, n_comb, build.GSUM_ROWS, build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_pair_dx", err)
    build.LAUNCHES["up_pair_dx"] += 1
    dmul1, dadd, dmul2 = daff
    return (tuple(grads[:4]), tuple(grads[4:]), dmul1, dadd, dmul2, dadd,
            gsums if emit_gsum else None)


def up_pair_operand_plain(b0, y10, affines, corner_mode="average"):
    """Plain version of ``up_pair_operand``: ``up_operand_plain`` of the
    joined grid."""
    return up_operand_plain(_pair_grid(b0, y10, affines), corner_mode)


def up_pair_operand(b0, y10, affines, corner_mode: str = "average"):
    """The upsampled operand of ``up_pair_fwd``'s level-s grid, as its bf16
    dtaps builds it (the pair joined once into a level-s grid, then the up
    conv's operand pass over it): ``up_operand`` of the joined grid.
    Arguments as ``up_pair_fwd``."""
    if not on_cuda(b0[0], "up_pair_operand"):
        return up_pair_operand_plain(b0, y10, affines, corner_mode)
    B, h, w, cin = _check_pair(b0, y10, affines, "up_pair_operand")
    dev, dt = b0[0].device, b0[0].dtype
    out = torch.empty((operand_rows(B, h, w), build.operand_width(cin)), dtype=dt, device=dev)
    joined = torch.empty((B, 5, h, w, cin), dtype=dt, device=dev)
    up_table = device_table("up", h, w, corner_mode, dev)
    with torch.cuda.device(dev):
        err = build.library().gn_up_pair_operand(
            build.ptr_array((*b0, *y10)), build.ptr_array(affines), up_table.data_ptr(),
            out.data_ptr(), joined.data_ptr(), B, h, w, cin, int(corner_mode == "zeros"),
            build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_pair_operand", err)
    build.LAUNCHES["up_pair_operand"] += 1
    return out


def up_pair_dtaps_plain(b0, y10, affines, g_groups, corner_mode, y_groups=None, gs_list=None):
    """Plain version of ``up_pair_dtaps``: ``up_dual_conv_dtaps_plain`` on the
    joined grid."""
    return up_dual_conv_dtaps_plain(_pair_grid(b0, y10, affines), g_groups, corner_mode,
                                    y_groups, gs_list)


def up_pair_dtaps(b0, y10, affines, g_groups, corner_mode, y_groups=None, gs_list=None):
    """Tap cotangents of ``up_pair_fwd`` summed over the batch (the dtaps
    kernel of ``_updp_bwd``): per set a float32 (7, C_in, C_out). Arguments
    as ``up_pair_dx``. In bf16 the pair is joined once, its operand built
    (``up_pair_operand``) and the up conv's tensor-core GEMM runs over it;
    in float32 the SIMT GEMM joins it on load."""
    if not on_cuda(b0[0], "up_pair_dtaps"):
        return up_pair_dtaps_plain(b0, y10, affines, g_groups, corner_mode, y_groups, gs_list)
    B, h, w, cin = _check_pair(b0, y10, affines, "up_pair_dtaps")
    dev, dt = b0[0].device, b0[0].dtype
    if len(g_groups) != 2 or any(len(g) != 4 for g in g_groups):
        raise ValueError("up_pair_dtaps: 2 sets of 4 cotangent phases")
    cout = g_groups[0][0].shape[-1]
    _check_cotangents(g_groups, y_groups, gs_list, (B, 5, h, w, cout), dt, dev, "up_pair_dtaps")
    kc, n_chunks, ws, operand = _up_dtaps_scratch(dt, B, h, w, cin, 2, cout, dev)
    joined = torch.empty((B, 5, h, w, cin), dtype=dt, device=dev) if operand is not None else None
    dtaps = [torch.empty((7, cin, cout), dtype=torch.float32, device=dev) for _ in range(2)]
    conv_table = device_table("phase", h, w, corner_mode, dev)
    up_table = device_table("up", h, w, corner_mode, dev)
    gp, yp, gs0, gs1 = _fold_ptrs(g_groups, y_groups, gs_list)
    with torch.cuda.device(dev):
        err = build.library().gn_up_pair_dtaps(
            build.ptr_array((*b0, *y10)), build.ptr_array(affines), gp, yp, gs0, gs1,
            conv_table.data_ptr(), up_table.data_ptr(), ws.data_ptr(), *_pair(dtaps),
            build.ptr(operand), build.ptr(joined), B, h, w, cin, cout, kc, n_chunks,
            int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_pair_dtaps", err)
    build.LAUNCHES["up_pair_dtaps"] += 1
    return tuple(dtaps)


# --------------------------------------------------------------------------
# the merged blocks (fused_up_block, fused_down_block: kernels o and p)
# --------------------------------------------------------------------------


def bn_affine_plain(stats, count, gamma, beta, eps=1e-5):
    """BatchNorm's (mul, add) from [Σy, Σy²] over ``count`` positions, as
    ``IcoBatchNorm.affine`` computes it in train mode (``_StatsBN``'s
    formula): mean = Σy/count, var = max(0, Σy²/count − mean²), mul =
    rsqrt(var + eps)·gamma, add = beta − mean·mul, float32."""
    mean = stats[0] / count
    var = torch.clamp_min(stats[1] / count - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * gamma
    return mul, beta - mean * mul


def up_block_fwd_plain(x, tap_sets, gamma, beta, corner_mode="average", eps=1e-5):
    """Plain version of ``up_block_fwd``: ``up_dual_conv_fwd_plain`` with
    stats, the affine, then ``phase_conv_fwd_plain`` with it as the act."""
    (y00, y10), (s00, s10) = up_dual_conv_fwd_plain(x, tap_sets[:2], corner_mode, True)
    mul00, add00 = bn_affine_plain(s00, 4.0 * y00[0].shape[:-1].numel(), gamma, beta, eps)
    (b0,), (s01,) = phase_conv_fwd_plain(y00, tap_sets[2:], corner_mode, _ALL, (mul00, add00),
                                         True)
    return b0, y10, y00, s00, s01, s10, mul00, add00


def _check_block(tap_sets, gamma, beta, cin, dt, dev, name):
    """(c0, c2) of a merged block's three tap sets and bn00's parameters."""
    if len(tap_sets) != 3:
        raise ValueError(f"{name}: takes 3 tap sets (conv00, conv10, conv01), got {len(tap_sets)}")
    c0 = _check_sets(tap_sets[:2], cin, dt, dev, name)
    c2 = _check_sets(tap_sets[2:], c0, dt, dev, f"{name} conv01")
    for a in (gamma, beta):
        expect(a, (c0,), torch.float32, dev, f"{name} gamma/beta")
    return c0, c2


def _block_outputs(dt, B, h, w, cin, c0, c2, n_out, dev):
    """Stats, affine, barrier and scratch of a merged block whose two passes
    write n_out output phases a sample (o: 4; p: 1, phase 2 and then the
    standard grid): the row tiles' partials (float32 the SIMT tiles', a row
    per 64 cells of a sample and output phase; bf16 the tensor-core GEMM's,
    a row per 128 rows) and, in bf16, one operand buffer that both passes'
    operands take in turn (pass A's of 4 sources a sample: o's upsampled
    phases, p's input phases; pass B's of y00's n_out) and the two packed
    tap sets."""
    s00, s10 = (torch.empty((2, c0), dtype=torch.float32, device=dev) for _ in range(2))
    s01 = torch.empty((2, c2), dtype=torch.float32, device=dev)
    mul00, add00 = (torch.empty(c0, dtype=torch.float32, device=dev) for _ in range(2))
    operand, wpack = None, (None, None)
    if dt == torch.bfloat16:
        rows = build.mma_fwd_grid(B * n_out * 5 * h * w, 1)[1]
        size = max(grid_operand_rows(B, h, w, 4) * build.operand_width(cin),
                   grid_operand_rows(B, h, w, n_out) * build.operand_width(c0))
        operand = torch.empty(size, dtype=dt, device=dev)
        wpack = tuple(torch.empty(build.packed_taps_shape(k, n), dtype=dt, device=dev)
                      for k, n in ((cin, 2 * c0), (c0, c2)))
    else:
        rows = B * n_out * build.n_tiles(5 * h * w)
    scratch = (build.scratch(rows * 4 * c0, dev), build.scratch(rows * 2 * c2, dev))
    # the grid barrier's 2 counters; bf16 also the blocks' SM order's
    order = build.MAX_SLOTS + build.MAX_SM_IDS if dt == torch.bfloat16 else 0
    bar = torch.zeros(2 + order, dtype=torch.int32, device=dev)
    return (s00, s10, s01, mul00, add00), scratch, bar, operand, wpack


def up_block_fwd(x, tap_sets, gamma, beta, corner_mode: str = "average", eps: float = 1e-5):
    """A whole UpBlock's training forward in one launch (the Pallas
    ``_up_block_fwd_impl``, kernel o).

    x: contiguous (B, 5, h, w, C_in) level-s grid (float32 or bfloat16);
    tap_sets: (taps, bias) of conv00 and conv10 (C_in -> C0) and of conv01
    (C0 -> C2), in x's dtype; gamma, beta: bn00's float32 (C0,). Pass A is
    ``up_dual_conv_fwd`` with stats, then mul00, add00 = bn00's affine of
    its batch moments (``bn_affine_plain``, count 4·B·5hw), then pass B
    ``phase_conv_fwd`` of y00 with act (mul00, add00) and stats. Returns
    (b0, y10, y00 (4-tuples of level-(s+1) phases), s00, s01, s10 (float32
    (2, C) [Σy, Σy²]), mul00, add00), as the Pallas call. float32 runs the
    SIMT tiles, bf16 the split route's tensor-core passes
    (``csrc/mma_block_fwd.cuh``); each output equals the split route's bit
    for bit."""
    if not on_cuda(x, "up_block_fwd"):
        return up_block_fwd_plain(x, tap_sets, gamma, beta, corner_mode, eps)
    B, _, h, w, cin = x.shape
    grid_level(h, w)
    dev, dt = x.device, x.dtype
    expect(x, (B, 5, h, w, cin), dt, dev, "up_block_fwd x")
    c0, c2 = _check_block(tap_sets, gamma, beta, cin, dt, dev, "up_block_fwd")
    M = 5 * h * w
    outs = [torch.empty((B, 5, h, w, c), dtype=dt, device=dev) for c in [c0] * 8 + [c2] * 4]
    stats, (part_a, part_b), bar, operand, wpack = _block_outputs(dt, B, h, w, cin, c0, c2, 4,
                                                                  dev)
    with torch.cuda.device(dev):
        err = build.library().gn_up_block_fwd(
            x.data_ptr(), build.ptr_array([t for pair in tap_sets for t in pair]),
            gamma.data_ptr(), beta.data_ptr(), build.ptr_array(outs),
            device_table("phase", h, w, corner_mode, dev).data_ptr(),
            device_table("up", h, w, corner_mode, dev).data_ptr(), part_a.data_ptr(),
            part_b.data_ptr(), *[t.data_ptr() for t in stats], bar.data_ptr(),
            build.ptr(operand), *map(build.ptr, wpack), B, h, w, cin, c0, c2, 4.0 * B * M, eps,
            int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("up_block_fwd", err)
    build.LAUNCHES["up_block_fwd"] += 1
    s00, s10, s01, mul00, add00 = stats
    return tuple(outs[8:]), tuple(outs[4:8]), tuple(outs[:4]), s00, s01, s10, mul00, add00


def dn_block_fwd_plain(phases, tap_sets, gamma, beta, in_act=None, corner_mode="average",
                       eps=1e-5):
    """Plain version of ``dn_block_fwd``: ``phase_conv_fwd_plain`` with
    output phase 2 and stats, the affine, then the standard conv
    (``ico_conv_s2s``) with it as the act, and its stats."""
    sets, (s00, s10) = phase_conv_fwd_plain(phases, tap_sets[:2], corner_mode, (2,), in_act,
                                            True)
    (y00,), (y10,) = sets
    mul00, add00 = bn_affine_plain(s00, float(y00.shape[:-1].numel()), gamma, beta, eps)
    b0 = ico_conv_s2s(act_apply(y00, (mul00, add00)), *tap_sets[2],
                      grid_level(y00.shape[2], y00.shape[3]), 1, corner_mode)
    return b0, y10, y00, s00, stats_plain([b0]), s10, mul00, add00


def dn_block_fwd(phases, tap_sets, gamma, beta, in_act=None, corner_mode: str = "average",
                 eps: float = 1e-5):
    """A whole DownBlock's training forward in one launch (the Pallas
    ``_dn_block_fwd_impl``, kernel p).

    phases: the 4 contiguous parity phases (B, 5, h, w, C_in) of the
    level-s input; tap_sets: (taps, bias) of conv00 and conv10 (C_in -> C0,
    stride 2) and of conv01 (C0 -> C2); gamma, beta: bn00's float32 (C0,);
    in_act: optional float32 (mul, add) (C_in,), the pending prologue. Pass
    A is ``phase_conv_fwd`` with output phase 2 (the standard level-(s-1)
    grid) and stats, then bn00's affine (count B·5hw), then pass B the
    standard conv (``ico_conv_s2s_fwd``) of y00 with act (mul00, add00) and
    stats. Returns (b0, y10, y00 ((B, 5, h, w, C) grids), s00, s01, s10,
    mul00, add00), as the Pallas call. float32 runs the SIMT tiles, bf16
    the split route's tensor-core passes, as ``up_block_fwd``."""
    if len(phases) != 4:
        raise ValueError(f"dn_block_fwd: takes 4 phases, got {len(phases)}")
    x0 = phases[0]
    if not on_cuda(x0, "dn_block_fwd"):
        return dn_block_fwd_plain(phases, tap_sets, gamma, beta, in_act, corner_mode, eps)
    B, _, h, w, cin = x0.shape
    grid_level(h, w)
    dev, dt = x0.device, x0.dtype
    for i, p in enumerate(phases):
        expect(p, (B, 5, h, w, cin), dt, dev, f"dn_block_fwd phase {i}")
    c0, c2 = _check_block(tap_sets, gamma, beta, cin, dt, dev, "dn_block_fwd")
    check_act(in_act, cin, dev, "dn_block_fwd")
    M = 5 * h * w
    outs = [torch.empty((B, 5, h, w, c), dtype=dt, device=dev) for c in (c0, c0, c2)]
    stats, (part_a, part_b), bar, operand, wpack = _block_outputs(dt, B, h, w, cin, c0, c2, 1,
                                                                  dev)
    mul, add = in_act if in_act is not None else (None, None)
    with torch.cuda.device(dev):
        err = build.library().gn_dn_block_fwd(
            build.ptr_array(phases), build.ptr(mul), build.ptr(add),
            build.ptr_array([t for pair in tap_sets for t in pair]), gamma.data_ptr(),
            beta.data_ptr(), build.ptr_array(outs),
            device_table("phase", h, w, corner_mode, dev).data_ptr(),
            device_table("std", h, w, corner_mode, dev).data_ptr(), part_a.data_ptr(),
            part_b.data_ptr(), *[t.data_ptr() for t in stats], bar.data_ptr(),
            build.ptr(operand), *map(build.ptr, wpack), B, h, w, cin, c0, c2, float(B * M), eps,
            int(corner_mode == "zeros"), build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("dn_block_fwd", err)
    build.LAUNCHES["dn_block_fwd"] += 1
    s00, s10, s01, mul00, add00 = stats
    return outs[2], outs[1], outs[0], s00, s01, s10, mul00, add00


# --------------------------------------------------------------------------
# pair head (fused_pair_head)
# --------------------------------------------------------------------------


def pair_head_fwd_plain(b0, y10, affines, W, bias):
    """Plain version: the residual join in float32, cast to the activation
    dtype; the 1×1 head with float32 sums plus bias, cast to the activation
    dtype; float32 tanh."""
    dt = b0[0].dtype
    outs = []
    for a, b in zip(b0, y10):
        t = pair_join(a, b, affines)
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


# --------------------------------------------------------------------------
# pair head + position loss (fused_pair_head_mse)
# --------------------------------------------------------------------------


def _check_head(b0, y10, affines, W, bias, name):
    """Shapes and types of the head's inputs; returns (B, h, w, C, F)."""
    x0 = b0[0]
    B, _, h, w, cin = x0.shape
    F = W.shape[-1]
    dev, dt = x0.device, x0.dtype
    if len(b0) != 4 or len(y10) != 4:
        raise ValueError(f"{name}: takes 4 + 4 phases")
    for i, p in enumerate((*b0, *y10)):
        expect(p, (B, 5, h, w, cin), dt, dev, f"{name} input {i}")
    for a in affines:
        expect(a, (cin,), torch.float32, dev, f"{name} affine")
    expect(W, (cin, F), dt, dev, f"{name} W")
    expect(bias, (F,), dt, dev, f"{name} bias")
    if not 1 <= F <= 8:
        raise ValueError(f"{name}: takes 1 <= F <= 8 outputs")
    return B, h, w, cin, F


def _check_targets(tpack, tpoles, B, h, w, F, dev, name):
    expect(tpack, (B, 5, h, w, 4 * F), torch.float32, dev, f"{name} tpack")
    expect(tpoles, (B, 2 * F), torch.float32, dev, f"{name} tpoles")


def _pole_means(v0, v3):
    """The two pole vertices of the output: the 5-chart means (sum in order,
    times 0.2) of phase 0 cell (0, 0) and phase 3 cell (h-1, w-1)."""
    pn = sum(v0[:, c, 0, 0, :] for c in range(5)) * 0.2
    ps = sum(v3[:, c, -1, -1, :] for c in range(5)) * 0.2
    return pn, ps


def pair_head_mse_fwd_plain(b0, y10, affines, W, bias, tpack, tpoles):
    """Plain version: ``pair_head_fwd_plain``'s outputs against the packed
    target, phase by phase, plus the two poles; float32 (B,)."""
    v = pair_head_fwd_plain(b0, y10, affines, W, bias)
    F = W.shape[-1]
    sse = sum(((vp - tpack[..., p * F : (p + 1) * F]) ** 2).sum(dim=(1, 2, 3, 4))
              for p, vp in enumerate(v))
    pn, ps = _pole_means(v[0], v[3])
    return sse + ((pn - tpoles[:, :F]) ** 2).sum(dim=1) + ((ps - tpoles[:, F:]) ** 2).sum(dim=1)


def pair_head_mse_fwd(b0, y10, affines, W, bias, tpack, tpoles):
    """Last-UpBlock tail + 1×1 head + tanh + position squared error, fused.

    b0, y10, affines, W, bias: as ``pair_head_fwd``; tpack float32 (B, 5, h,
    w, 4F) and tpoles float32 (B, 2F) from ``ops/vertices.pack_target_phases``.
    Returns the per-sample squared-error sum over every grid cell and the two
    pole vertices, float32 (B,). The reconstruction is never written."""
    if not on_cuda(b0[0], "pair_head_mse_fwd"):
        return pair_head_mse_fwd_plain(b0, y10, affines, W, bias, tpack, tpoles)
    B, h, w, cin, F = _check_head(b0, y10, affines, W, bias, "pair_head_mse_fwd")
    dev, dt = b0[0].device, b0[0].dtype
    _check_targets(tpack, tpoles, B, h, w, F, dev, "pair_head_mse_fwd")
    part = build.scratch(build.head_mse_parts(B, h, w), dev)
    sse = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().gn_pair_head_mse_fwd(
            build.ptr_array((*b0, *y10)), *[a.data_ptr() for a in affines], W.data_ptr(),
            bias.data_ptr(), tpack.data_ptr(), tpoles.data_ptr(), part.data_ptr(),
            sse.data_ptr(), B, h, w, cin, F, build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("pair_head_mse_fwd", err)
    build.LAUNCHES["pair_head_mse_fwd"] += 1
    return sse


def _head_bwd_plain(b0, y10, affines, W, bias, dv_of):
    """The head's backward written out (autograd through the bf16 cast of
    the head's pre-activation would round its cotangent), for the float32
    cotangent ``dv_of(p, v)`` of output phase p given its values v: the
    8 phase cotangents in the phases' dtype, then float32 dW, dbias, d_mul1,
    d_add1, d_mul2, d_add2 (= d_add1)."""
    mul1, add1, mul2, add2 = affines
    dt, F = b0[0].dtype, W.shape[-1]
    W32 = W.float()
    db0, dy10, dW, dbias, dmul1, dadd1, dmul2 = [], [], 0.0, 0.0, 0.0, 0.0, 0.0
    dims = (0, 1, 2, 3)
    for p, (a, b, v) in enumerate(zip(b0, y10, pair_head_fwd_plain(b0, y10, affines, W, bias))):
        a32, b32 = a.float(), b.float()
        pre = a32 * mul1 + add1 + b32 * mul2 + add2
        t = torch.clamp_min(pre, 0.0).to(dt).float()
        dz = dv_of(p, v) * (1.0 - v * v)
        dbias = dbias + dz.sum(dim=dims)
        dW = dW + t.reshape(-1, t.shape[-1]).T @ dz.reshape(-1, F)
        dm = (dz @ W32.T) * (pre > 0.0).float()
        db0.append((dm * mul1).to(dt))
        dy10.append((dm * mul2).to(dt))
        dmul1 = dmul1 + (dm * a32).sum(dim=dims)
        dadd1 = dadd1 + dm.sum(dim=dims)
        dmul2 = dmul2 + (dm * b32).sum(dim=dims)
    return tuple(db0), tuple(dy10), dW, dbias, dmul1, dadd1, dmul2, dadd1


def pair_head_bwd_plain(g, b0, y10, affines, W, bias):
    """Plain version of ``pair_head_bwd``."""
    db0, dy10, dW, dbias, *daff = _head_bwd_plain(b0, y10, affines, W, bias,
                                                  lambda p, v: g[p].float())
    return db0, dy10, dW.to(W.dtype), dbias.to(bias.dtype), *daff


def pair_head_bwd(g, b0, y10, affines, W, bias):
    """Backward of ``pair_head_fwd`` (the Pallas ``_phead_bwd``) for the
    float32 cotangents g, a 4-tuple of contiguous (B, 5, h, w, F), of its
    output phases: recomputes the head and returns (4 db0 phases, 4 dy10
    phases in the phases' dtype, dW (C, F) and dbias (F) rounded to W's
    dtype, d_mul1, d_add1, d_mul2, d_add2 float32 (C,)); d_add2 equals
    d_add1, since both affines' shifts add to one sum."""
    if not on_cuda(b0[0], "pair_head_bwd"):
        return pair_head_bwd_plain(g, b0, y10, affines, W, bias)
    B, h, w, cin, F = _check_head(b0, y10, affines, W, bias, "pair_head_bwd")
    dev, dt = b0[0].device, b0[0].dtype
    if len(g) != 4:
        raise ValueError("pair_head_bwd: takes 4 cotangent phases")
    for i, gp in enumerate(g):
        expect(gp, (B, 5, h, w, F), torch.float32, dev, f"pair_head_bwd g {i}")
    grads = [torch.empty_like(b0[0]) for _ in range(8)]
    part = build.scratch(build.head_bwd_blocks(B, h, w) * (cin * F + F + 3 * cin), dev)
    dW = torch.empty((cin, F), dtype=torch.float32, device=dev)
    vecs = [torch.empty(n, dtype=torch.float32, device=dev) for n in (F, cin, cin, cin, cin)]
    with torch.cuda.device(dev):
        err = build.library().gn_pair_head_bwd(
            build.ptr_array(g), build.ptr_array((*b0, *y10)), *[a.data_ptr() for a in affines],
            W.data_ptr(), bias.data_ptr(), build.ptr_array(grads), part.data_ptr(),
            dW.data_ptr(), *[v.data_ptr() for v in vecs], B, h, w, cin, F,
            build.dtype_code(dt), build.stream_ptr(dev),
        )
    build.check("pair_head_bwd", err)
    build.LAUNCHES["pair_head_bwd"] += 1
    dbias, *daff = vecs
    return tuple(grads[:4]), tuple(grads[4:]), dW.to(W.dtype), dbias.to(bias.dtype), *daff


def pair_head_mse_bwd_plain(g, b0, y10, affines, W, bias, tpack, tpoles):
    """Plain version of ``pair_head_mse_bwd``: the head's backward with the
    cotangent of v from the target and the poles."""
    F = W.shape[-1]
    g = g.float()
    gb = g.reshape(-1, 1, 1, 1, 1)
    vs = pair_head_fwd_plain(b0, y10, affines, W, bias)
    pn, ps = _pole_means(vs[0], vs[3])
    dpn = (g[:, None] * 2.0 * (pn - tpoles[:, :F])) * 0.2
    dps = (g[:, None] * 2.0 * (ps - tpoles[:, F:])) * 0.2

    def dv_of(p, v):
        dv = gb * 2.0 * (v - tpack[..., p * F : (p + 1) * F])
        if p == 0:
            dv[:, :, 0, 0, :] += dpn[:, None, :]
        if p == 3:
            dv[:, :, -1, -1, :] += dps[:, None, :]
        return dv

    return _head_bwd_plain(b0, y10, affines, W, bias, dv_of)


def pair_head_mse_bwd(g, b0, y10, affines, W, bias, tpack, tpoles):
    """Backward of ``pair_head_mse_fwd`` (the Pallas ``_phmse_bwd``) for the
    float32 (B,) cotangent g of the per-sample error: recomputes the head and
    returns (4 db0 phases, 4 dy10 phases in the phases' dtype, dW float32
    (C, F), dbias float32 (F,), d_mul1, d_add1, d_mul2, d_add2 float32 (C,));
    d_add2 equals d_add1, since both affines' shifts add to one sum."""
    if not on_cuda(b0[0], "pair_head_mse_bwd"):
        return pair_head_mse_bwd_plain(g, b0, y10, affines, W, bias, tpack, tpoles)
    B, h, w, cin, F = _check_head(b0, y10, affines, W, bias, "pair_head_mse_bwd")
    dev, dt = b0[0].device, b0[0].dtype
    _check_targets(tpack, tpoles, B, h, w, F, dev, "pair_head_mse_bwd")
    expect(g, (B,), torch.float32, dev, "pair_head_mse_bwd g")
    grads = [torch.empty_like(b0[0]) for _ in range(8)]
    dpole = build.scratch(B * 2 * F, dev)
    part = build.scratch(build.head_bwd_blocks(B, h, w) * (cin * F + F + 3 * cin), dev)
    dW = torch.empty((cin, F), dtype=torch.float32, device=dev)
    vecs = [torch.empty(n, dtype=torch.float32, device=dev) for n in (F, cin, cin, cin, cin)]
    with torch.cuda.device(dev):
        err = build.library().gn_pair_head_mse_bwd(
            g.data_ptr(), build.ptr_array((*b0, *y10)), *[a.data_ptr() for a in affines],
            W.data_ptr(), bias.data_ptr(), tpack.data_ptr(), tpoles.data_ptr(),
            build.ptr_array(grads), dpole.data_ptr(), part.data_ptr(), dW.data_ptr(),
            *[v.data_ptr() for v in vecs], B, h, w, cin, F, build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("pair_head_mse_bwd", err)
    build.LAUNCHES["pair_head_mse_bwd"] += 1
    return tuple(grads[:4]), tuple(grads[4:]), dW, *vecs

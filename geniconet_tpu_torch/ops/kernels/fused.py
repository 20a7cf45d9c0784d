"""The fused convs and the fused head+MSE with their hand-written backward,
as ``torch.autograd.Function``s.

Port of the custom VJPs of ``geniconet_tpu/ops/pallas/phase_kernel.py`` and
``conv_kernel.py``, with their names and arguments:

* ``fused_phase_conv_s1`` (``_pcs1``): 4 phases -> 4 phases, stride 1;
* ``fused_dual_s2_conv``  (``_ds2``): a DownBlock's two stride-2 convs;
* ``fused_dual_s2_conv_split`` (``_ds2s``): the same, with both outputs as
  the 4 parity phases of the level-(s-1) grid (the encoder's phase chain):
  ``ds2s_fwd`` + ``ds2s_dx`` / ``ds2s_dtaps``;
* ``fused_up_dual_conv``  (``_upd``): an UpBlock's upsample + two convs;
* ``fused_up_dual_conv_pair`` (``_updp``): the same on the previous
  UpBlock's residual tail, given as its raw phase pair and four affines
  (the decoder's phase chain): ``up_pair_fwd`` + ``up_pair_dx`` /
  ``up_pair_dtaps``;
* ``fused_ico_conv_s2s``  (``_fic``): the standard-layout conv, stride 1
  (a DownBlock's conv01) or 2: ``ico_conv_s2s_fwd`` + ``ico_conv_s2s_dx`` /
  ``ico_conv_s2s_dtaps``;
* ``fused_up_block`` (``_upblk``) and ``fused_down_block`` (``_dnblk``): a
  whole UpBlock's or DownBlock's training forward in one launch (kernels
  o, ``up_block_fwd``, and p, ``dn_block_fwd``), bn00's affine computed in
  the kernel; no backward kernel of their own: the backward bodies
  ``_pcs1_bwd`` / ``_upd_bwd`` and ``_std_bwd`` / ``_ds2_bwd`` (which the
  split Functions run too) around the affine's (C,)-sized VJP;
* ``fused_pair_head`` (``_phead``): the decoder tail + head + tanh, 4 output
  phases: ``pair_head_fwd`` / ``pair_head_bwd`` (the VAE's training loss);
* ``fused_pair_head_mse`` (``_phmse``): the decoder tail + head + tanh +
  per-sample position squared error: ``pair_head_mse_fwd`` /
  ``pair_head_mse_bwd``.

Forward: ``phase_conv_fwd`` / ``up_dual_conv_fwd``. With ``with_stats`` the
(2, C_out) float32 [Σy, Σy²] of each tap set's output is a differentiable
output; the backward folds its cotangent into the kernels' g as
g_eff = g + gs0 + 2·gs1·y (float32, cast to the activation dtype) and takes
the bias gradient from Σg_eff. dtaps are rounded to the taps' dtype. The act
prologue's (mul, add) get their gradients d_mul, d_add from the dx kernel.

Two backward routes, chosen per call by the keyword ``merged_bwd`` (the
model option of the same name picks it per kernel family, as
``GENICONET_MERGED_BWD`` does in JAX):

* split (the default): a dx and a dtaps kernel, ``phase_conv_dx`` +
  ``phase_conv_dtaps`` / ``up_dual_conv_dx`` + ``up_dual_conv_dtaps`` /
  ``ico_conv_s2s_dx`` + ``ico_conv_s2s_dtaps``;
* merged: one kernel per conv, ``phase_conv_bwd`` (``_phase_conv_bwd``),
  ``up_dual_conv_bwd`` (``_upd_bwd``'s merged branch) and
  ``ico_conv_s2s_bwd`` (``_std_bwd``), which emit dx, dtaps, Σg_eff and
  d_mul/d_add from one launch. A phase conv without an input cotangent
  (``needs_dx=False``) keeps the dtaps kernel, as ``_pcs1_bwd`` does.
  ``fused_dual_s2_conv_split`` and ``fused_up_dual_conv_pair`` have no
  merged branch, as in JAX.

Where the fold runs, on the split route, is the JAX signatures' ``fold_ok``
and ``fold_site`` with the option ``kernel_geff`` (``kernel_geff_enabled``,
the JAX package's ``GENICONET_KERNEL_GEFF``). Each call names its kernel
family as ``_pcs1_bwd``, ``_ds2_bwd``, ``_ds2s_bwd``, ``_upd_bwd``,
``_updp_bwd`` and the standard conv's ``_bwd`` do: ``pcs1_front`` (no input
cotangent), ``pcs1_<fold_site>`` or ``pcs1``, ``ds2`` (both stride-2
Functions), ``upd`` (both up Functions), ``std``. A family in the set folds inside its kernels; any other
runs the fold before them as ``stats_geff`` (kernel l, one launch per tap
set) and passes its kernels g_eff with no fold, and the bias gradient then
comes from the dtaps kernel's Σg (the phase convs) or the dx kernel's (the
up and standard convs). ``kernel_geff=None``, the default, folds every
family inside. The merged route always folds inside, as the JAX merged
branches run before the fold test.

Each Function's forward and backward run in the spans ``kernel.<Name>``
and ``kernel.<Name>.bwd`` (``tracing``; the class name without its
underscore), which time the wrappers on the host.
"""

from __future__ import annotations

import functools

import torch

from geniconet_tpu_torch import tracing
from geniconet_tpu_torch.ops.kernels.build import grid_level
from geniconet_tpu_torch.ops.kernels.conv_kernel import (
    ico_conv_s2s_bwd, ico_conv_s2s_dtaps, ico_conv_s2s_dx, ico_conv_s2s_fwd,
)
from geniconet_tpu_torch.ops.kernels.phase_kernel import (
    bn_affine_plain, dn_block_fwd, ds2s_dtaps, ds2s_dx, ds2s_fwd, pair_head_bwd, pair_head_fwd,
    pair_head_mse_bwd, pair_head_mse_fwd, phase_conv_bwd, phase_conv_dtaps, phase_conv_dx,
    phase_conv_fwd, stats_geff, up_block_fwd, up_dual_conv_bwd, up_dual_conv_dtaps,
    up_dual_conv_dx, up_dual_conv_fwd, up_pair_dtaps, up_pair_dx, up_pair_fwd,
)

__all__ = ["fused_phase_conv_s1", "fused_dual_s2_conv", "fused_dual_s2_conv_split",
           "fused_up_dual_conv", "fused_up_dual_conv_pair", "fused_ico_conv_s2s", "fused_up_block",
           "fused_down_block", "fused_pair_head", "fused_pair_head_mse", "kernel_geff_enabled",
           "merged_bwd_enabled"]

_ALL = (0, 1, 2, 3)


def merged_bwd_enabled(family: str, merged_bwd: str | None) -> bool:
    """The JAX package's ``GENICONET_MERGED_BWD`` routing as a model option:
    None, "" or "0" is off (the split dx + dtaps kernels), "1" or "all"
    merges every family, and a comma list merges the families it names
    (``pcs1``, ``ds2``, ``upd``, ``std``)."""
    if merged_bwd in (None, "", "0"):
        return False
    if merged_bwd in ("1", "all"):
        return True
    return family in {f.strip() for f in merged_bwd.split(",")}


def kernel_geff_enabled(family: str, kernel_geff: str | None, allow: bool = True) -> bool:
    """Whether kernel ``family`` folds the stats cotangent inside its
    backward kernels: the JAX package's ``_kernel_geff_enabled`` with the
    value of ``GENICONET_KERNEL_GEFF`` as ``kernel_geff``. "" is JAX's
    built-in set (``pcs1_front``, ``upd``), "0" none, "1"/"all" every
    family, else a comma list of families. ``allow=False`` (a restricted
    ``pallas_blocks`` model, JAX's ``fold_ok``) folds none unless the value
    starts with "!". None, the port's default, folds every family."""
    if kernel_geff is None:
        return True
    v = kernel_geff
    if v.startswith("!"):
        v = v[1:]
    elif not allow:
        return False
    if v == "":
        return family in ("pcs1_front", "upd")
    if v == "0":
        return False
    if v in ("1", "all"):
        return True
    return family in {f.strip() for f in v.split(",")}


def _groups(grads, n_sets, n):
    return [[g.contiguous() for g in grads[s * n : (s + 1) * n]] for s in range(n_sets)]


def _fold(with_stats, in_kernel, g_groups, ys, stat_grads, n_sets, n):
    """(g_groups, fold kwargs of the kernels): with stats, the fold inside
    the kernels (``y_groups``, ``gs_list``) or before them (``stats_geff``
    per tap set, then no fold)."""
    if not with_stats:
        return g_groups, {}
    y_groups = _groups(ys, n_sets, n)
    gs_list = [g.float().contiguous() for g in stat_grads]
    if in_kernel:
        return g_groups, dict(y_groups=y_groups, gs_list=gs_list)
    return [list(stats_geff(g, y, gs)) for g, y, gs in zip(g_groups, y_groups, gs_list)], {}


class _PhaseConv(torch.autograd.Function):
    """Inputs: the non-tensor settings, then 4 phases, n_sets taps, n_sets
    biases (or None), act mul, add (or None). Outputs: n_sets × n_out
    phases, then n_sets stats when with_stats."""

    @staticmethod
    def forward(ctx, corner_mode, out_phases, n_sets, with_stats, needs_dx, merged_bwd, fold,
                *tensors):
        with tracing.span("kernel.PhaseConv"):
            phases, taps = tensors[:4], tensors[4 : 4 + n_sets]
            biases = tensors[4 + n_sets : 4 + 2 * n_sets]
            mul, add = tensors[4 + 2 * n_sets :]
            act = None if mul is None else (mul, add)
            r = phase_conv_fwd(phases, list(zip(taps, biases)), corner_mode, out_phases, act,
                               with_stats)
            sets, stats = r if with_stats else (r, [])
            outs = [o for group in sets for o in group]
            ctx.settings = (corner_mode, out_phases, n_sets, with_stats, needs_dx, merged_bwd, fold,
                            [b is not None for b in biases])
            ctx.save_for_backward(*phases, *taps, mul, add, *(outs if with_stats else ()))
            return (*outs, *stats)

    @staticmethod
    def backward(ctx, *grads):
        with tracing.span("kernel.PhaseConv.bwd"):
            (corner_mode, out_phases, n_sets, with_stats, needs_dx, merged_bwd, fold,
             has_bias) = ctx.settings
            saved = ctx.saved_tensors
            mul, add = saved[4 + n_sets : 6 + n_sets]
            n = n_sets * len(out_phases)
            dphases, dtaps, dbias, dmul, dadd = _phase_bwd(
                out_phases, corner_mode, with_stats, needs_dx, merged_bwd, fold, has_bias,
                saved[:4], saved[4 : 4 + n_sets], None if mul is None else (mul, add),
                saved[6 + n_sets :], grads[:n], grads[n:])
            return (None,) * 7 + (*dphases, *dtaps, *dbias, dmul, dadd)


def _phase_bwd(out_phases, corner_mode, with_stats, needs_dx, merged_bwd, fold, has_bias, phases,
               taps, act, ys, g_out, g_stats):
    """The phase conv's backward (JAX's ``_pcs1_bwd`` / ``_ds2_bwd``): the
    forward's 4 raw input phases, its taps per set, act, outputs ``ys`` and
    the cotangents of its outputs and stats (flat, set-major) -> (4 input
    cotangents or Nones, dtaps and dbias per set in the taps' dtype, d_mul,
    d_add). Merged (with ``needs_dx``) or split, the fold inside or before
    the kernels (module doc)."""
    n_sets, n_out = len(taps), len(out_phases)
    dt, cin = phases[0].dtype, phases[0].shape[-1]
    merged = needs_dx and merged_bwd
    g_groups, fk = _fold(with_stats, fold or merged, _groups(g_out, n_sets, n_out), ys, g_stats,
                         n_sets, n_out)
    sets = [(t, None) for t in taps]
    dphases, dmul, dadd, gsums = (None,) * 4, None, None, None
    if merged:
        dphases, dtaps, gsums, dmul, dadd = phase_conv_bwd(
            phases, g_groups, fk.get("y_groups"), fk.get("gs_list"), sets, corner_mode,
            out_phases, act, with_stats, dt)
    else:
        if needs_dx:
            dphases, dmul, dadd, gsums = phase_conv_dx(
                g_groups, sets, corner_mode, out_phases, cin, dt, act, phases, **fk)
        # the bias gradient rides the dtaps kernel unless the dx kernel made it
        want_gsum = gsums is None and any(has_bias)
        r = phase_conv_dtaps(phases, g_groups, [t.shape for t in taps], corner_mode,
                             out_phases, act, emit_gsum=want_gsum, **fk)
        dtaps, gsums = r if want_gsum else (r, gsums)
    dbias = [gsums[s].to(t.dtype) if has_bias[s] else None for s, t in enumerate(taps)]
    return dphases, [d.to(t.dtype) for d, t in zip(dtaps, taps)], dbias, dmul, dadd


# fused_phase_conv_s1's and fused_dual_s2_conv's backward, by JAX's names
_pcs1_bwd = functools.partial(_phase_bwd, _ALL)
_ds2_bwd = functools.partial(_phase_bwd, (2,))


def fused_phase_conv_s1(phases, taps, bias, corner_mode="average", act=None, with_stats=False,
                        needs_dx=True, merged_bwd: bool = False, fold_ok: bool = True,
                        fold_site: str = "", kernel_geff: str | None = None):
    """Stride-1 hex conv in phase form: 4 phases in -> 4 phases out.

    act: optional float32 (mul, add) (C_in,) BN-apply + ReLU prologue.
    with_stats: also return the (2, C_out) float32 [Σy, Σy²] of the output.
    needs_dx=False skips the input-cotangent kernel (for data inputs).
    merged_bwd: the backward as one merged kernel (with needs_dx).
    fold_ok, fold_site, kernel_geff: where the stats fold runs (module doc;
    family ``pcs1_front``, ``pcs1_<fold_site>`` or ``pcs1``)."""
    mul, add = act if act is not None else (None, None)
    family = "pcs1_front" if not needs_dx else f"pcs1_{fold_site}" if fold_site else "pcs1"
    fold = kernel_geff_enabled(family, kernel_geff, fold_ok)
    r = _PhaseConv.apply(corner_mode, _ALL, 1, with_stats, needs_dx, merged_bwd, fold, *phases,
                         taps, bias, mul, add)
    return (tuple(r[:4]), r[4]) if with_stats else tuple(r)


def fused_dual_s2_conv(phases, taps_a, bias_a, taps_b, bias_b, corner_mode="average", act=None,
                       with_stats=False, merged_bwd: bool = False, fold_ok: bool = True,
                       kernel_geff: str | None = None):
    """Both stride-2 convs of a DownBlock in one kernel: the 4 parity phases
    of the level-s input -> (y_a, y_b), standard level-(s-1) tensors
    (output phase 2 of the phase conv) [+ their (2, C) stats]. merged_bwd:
    the backward as one merged kernel; fold_ok, kernel_geff: where the stats
    fold runs (family ``ds2``)."""
    mul, add = act if act is not None else (None, None)
    fold = kernel_geff_enabled("ds2", kernel_geff, fold_ok)
    return _PhaseConv.apply(corner_mode, (2,), 2, with_stats, True, merged_bwd, fold, *phases,
                            taps_a, taps_b, bias_a, bias_b, mul, add)


class _DualS2Split(torch.autograd.Function):
    """Inputs: settings, 4 phases, taps_a, taps_b, bias_a, bias_b (or None),
    act mul, add (or None). Outputs: 4 + 4 level-(s-1) phases, then 2 stats
    when with_stats."""

    @staticmethod
    def forward(ctx, corner_mode, with_stats, fold, *tensors):
        with tracing.span("kernel.DualS2Split"):
            phases, (ta, tb, ba, bb, mul, add) = tensors[:4], tensors[4:]
            act = None if mul is None else (mul, add)
            r = ds2s_fwd(phases, [(ta, ba), (tb, bb)], corner_mode, act, with_stats)
            sets, stats = r if with_stats else (r, [])
            outs = [*sets[0], *sets[1]]
            ctx.settings = (corner_mode, with_stats, fold, ba is not None, bb is not None)
            ctx.save_for_backward(*phases, ta, tb, mul, add, *(outs if with_stats else ()))
            return (*outs, *stats)

    @staticmethod
    def backward(ctx, *grads):
        with tracing.span("kernel.DualS2Split.bwd"):
            corner_mode, with_stats, fold, has_a, has_b = ctx.settings
            saved = ctx.saved_tensors
            phases, (ta, tb, mul, add) = saved[:4], saved[4:8]
            act = None if mul is None else (mul, add)
            dt, cin = phases[0].dtype, phases[0].shape[-1]
            g_groups, fk = _fold(with_stats, fold, _groups(grads, 2, 4), saved[8:], grads[8:], 2, 4)
            sets = [(ta, None), (tb, None)]
            dphases, dmul, dadd, gsums = ds2s_dx(g_groups, sets, corner_mode, cin, dt, act, phases,
                                                 **fk)
            # the bias gradients ride the dtaps kernel unless the dx kernel's fold made them
            want_gsum = gsums is None and (has_a or has_b)
            r = ds2s_dtaps(phases, g_groups, [ta.shape, tb.shape], corner_mode, act,
                           emit_gsum=want_gsum, **fk)
            (dta, dtb), gsums = r if want_gsum else (r, gsums)
            dba = gsums[0].to(ta.dtype) if has_a else None
            dbb = gsums[1].to(tb.dtype) if has_b else None
            return (None,) * 3 + (*dphases, dta.to(ta.dtype), dtb.to(tb.dtype), dba, dbb, dmul,
                                  dadd)


def fused_dual_s2_conv_split(phases, taps_a, bias_a, taps_b, bias_b, corner_mode="average",
                             act=None, with_stats=False, fold_ok: bool = True,
                             kernel_geff: str | None = None):
    """Both stride-2 convs of a DownBlock, their outputs emitted as the 4
    parity phases of the level-(s-1) grid (the encoder's phase chain): the
    4 phases of the level-s input -> (ya_phases, yb_phases) 4-tuples [+ the
    two (2, C) stats]. act: optional float32 (mul, add) prologue; fold_ok,
    kernel_geff: where the stats fold runs (family ``ds2``)."""
    mul, add = act if act is not None else (None, None)
    fold = kernel_geff_enabled("ds2", kernel_geff, fold_ok)
    r = _DualS2Split.apply(corner_mode, with_stats, fold, *phases, taps_a, taps_b, bias_a, bias_b,
                           mul, add)
    out = (tuple(r[0:4]), tuple(r[4:8]))
    return (*out, r[8], r[9]) if with_stats else out


class _UpDual(torch.autograd.Function):
    """Inputs: settings, x, taps_a, bias_a, taps_b, bias_b. Outputs: 4 + 4
    phases, then 2 stats when with_stats."""

    @staticmethod
    def forward(ctx, corner_mode, with_stats, merged_bwd, fold, x, taps_a, bias_a, taps_b,
                bias_b):
        with tracing.span("kernel.UpDual"):
            r = up_dual_conv_fwd(x, [(taps_a, bias_a), (taps_b, bias_b)], corner_mode, with_stats)
            sets, stats = r if with_stats else (r, [])
            outs = [*sets[0], *sets[1]]
            ctx.settings = (corner_mode, with_stats, merged_bwd, fold, bias_a is not None,
                            bias_b is not None)
            ctx.save_for_backward(x, taps_a, taps_b, *(outs if with_stats else ()))
            return (*outs, *stats)

    @staticmethod
    def backward(ctx, *grads):
        with tracing.span("kernel.UpDual.bwd"):
            corner_mode, with_stats, merged_bwd, fold, has_a, has_b = ctx.settings
            x, taps_a, taps_b, *ys = ctx.saved_tensors
            dx, (dta, dtb), (dba, dbb) = _upd_bwd(corner_mode, with_stats, merged_bwd, fold,
                                                  (has_a, has_b), x, (taps_a, taps_b), ys,
                                                  grads[:8], grads[8:])
            return None, None, None, None, dx, dta, dba, dtb, dbb


def _upd_bwd(corner_mode, with_stats, merged_bwd, fold, has_bias, x, taps, ys, g_out, g_stats):
    """The up conv's backward (JAX's ``_upd_bwd``): the forward's level-s x,
    its two tap sets, outputs ``ys`` and the cotangents of its 8 output
    phases and 2 stats -> (dx, dtaps and dbias per set in the taps' dtype)."""
    # Σg rides the dx kernel with the fold in or out of the kernels
    g_groups, fk = _fold(with_stats, fold or merged_bwd, _groups(g_out, 2, 4), ys, g_stats, 2, 4)
    sets = [(t, None) for t in taps]
    if merged_bwd:
        dx, *dtaps, g0, g1 = up_dual_conv_bwd(x, g_groups, sets, corner_mode, **fk)
        gsums = (g0, g1)
    else:
        dx, gsums = up_dual_conv_dx(g_groups, sets, corner_mode, x.dtype,
                                    emit_gsum=any(has_bias), **fk)
        dtaps = up_dual_conv_dtaps(x, g_groups, corner_mode, **fk)
    dbias = [gsums[s].to(t.dtype) if has_bias[s] else None for s, t in enumerate(taps)]
    return dx, [d.to(t.dtype) for d, t in zip(dtaps, taps)], dbias


def fused_up_dual_conv(x, taps_a, bias_a, taps_b, bias_b, corner_mode="average",
                       with_stats=False, merged_bwd: bool = False, fold_ok: bool = True,
                       kernel_geff: str | None = None):
    """An UpBlock's upsample + both first convs, fused: standard level-s
    (B, 5, h, w, C_in) in -> two 4-tuples of level-(s+1) phases [+ the two
    (2, C_out) stats]. merged_bwd: the backward as one merged kernel;
    fold_ok, kernel_geff: where the stats fold runs (family ``upd``)."""
    fold = kernel_geff_enabled("upd", kernel_geff, fold_ok)
    r = _UpDual.apply(corner_mode, with_stats, merged_bwd, fold, x, taps_a, bias_a, taps_b,
                      bias_b)
    out = (tuple(r[0:4]), tuple(r[4:8]))
    return (*out, r[8], r[9]) if with_stats else out


class _UpDualPair(torch.autograd.Function):
    """Inputs: settings, 4 b0 phases, 4 y10 phases, mul1, add1, mul2, add2,
    taps_a, bias_a, taps_b, bias_b. Outputs: 4 + 4 phases, then 2 stats when
    with_stats."""

    @staticmethod
    def forward(ctx, corner_mode, with_stats, fold, *tensors):
        with tracing.span("kernel.UpDualPair"):
            pair, affines = tensors[:8], tensors[8:12]
            taps_a, bias_a, taps_b, bias_b = tensors[12:]
            r = up_pair_fwd(pair[:4], pair[4:], affines, [(taps_a, bias_a), (taps_b, bias_b)],
                            corner_mode, with_stats)
            sets, stats = r if with_stats else (r, [])
            outs = [*sets[0], *sets[1]]
            ctx.settings = (corner_mode, with_stats, fold, bias_a is not None, bias_b is not None)
            ctx.save_for_backward(*pair, *affines, taps_a, taps_b, *(outs if with_stats else ()))
            return (*outs, *stats)

    @staticmethod
    def backward(ctx, *grads):
        with tracing.span("kernel.UpDualPair.bwd"):
            corner_mode, with_stats, fold, has_a, has_b = ctx.settings
            saved = ctx.saved_tensors
            b0, y10, affines, (taps_a, taps_b) = saved[:4], saved[4:8], saved[8:12], saved[12:14]
            # Σg rides the dx kernel with the fold in or out of the kernels
            g_groups, fk = _fold(with_stats, fold, _groups(grads, 2, 4), saved[14:], grads[8:], 2,
                                 4)
            sets = [(taps_a, None), (taps_b, None)]
            db0, dy10, *daff, gsums = up_pair_dx(g_groups, b0, y10, affines, sets, corner_mode,
                                                 emit_gsum=has_a or has_b, **fk)
            dta, dtb = up_pair_dtaps(b0, y10, affines, g_groups, corner_mode, **fk)
            dba = gsums[0].to(taps_a.dtype) if has_a else None
            dbb = gsums[1].to(taps_b.dtype) if has_b else None
            return (None,) * 3 + (*db0, *dy10, *daff, dta.to(taps_a.dtype), dba,
                                  dtb.to(taps_b.dtype), dbb)


def fused_up_dual_conv_pair(b0, y10, affines, taps_a, bias_a, taps_b, bias_b,
                            corner_mode="average", with_stats=False, fold_ok: bool = True,
                            kernel_geff: str | None = None):
    """The decoder's phase chain: the previous UpBlock's residual tail +
    upsample + both first convs, fused. b0, y10: 4-tuples of contiguous
    level-s phases (B, 5, h/2, w/2, C_in); affines: float32 (mul1, add1,
    mul2, add2) (C_in,), the previous block's pending bn01 / bn10 applies.
    Returns what ``fused_up_dual_conv`` returns for the joined grid, which
    never reaches device memory; the backward gives the 8 phase
    cotangents and the 4 affine gradients. fold_ok, kernel_geff: where the
    stats fold runs (family ``upd``)."""
    fold = kernel_geff_enabled("upd", kernel_geff, fold_ok)
    r = _UpDualPair.apply(corner_mode, with_stats, fold, *b0, *y10, *affines, taps_a, bias_a,
                          taps_b, bias_b)
    out = (tuple(r[0:4]), tuple(r[4:8]))
    return (*out, r[8], r[9]) if with_stats else out


class _IcoConv(torch.autograd.Function):
    """Inputs: settings, x, taps, bias (or None), act mul, add (or None).
    Outputs: y, then its stats when with_stats."""

    @staticmethod
    def forward(ctx, corner_mode, with_stats, merged_bwd, fold, stride, x, taps, bias, mul,
                add):
        with tracing.span("kernel.IcoConv"):
            act = None if mul is None else (mul, add)
            r = ico_conv_s2s_fwd(x, taps, bias, corner_mode, act, with_stats, stride=stride)
            y = r[0] if with_stats else r
            ctx.settings = (corner_mode, with_stats, merged_bwd, fold, stride, bias is not None)
            ctx.save_for_backward(x, taps, mul, add, y if with_stats else None)
            return r

    @staticmethod
    def backward(ctx, gy, gst=None):
        with tracing.span("kernel.IcoConv.bwd"):
            corner_mode, with_stats, merged_bwd, fold, stride, has_bias = ctx.settings
            x, taps, mul, add, y = ctx.saved_tensors
            act = None if mul is None else (mul, add)
            dx, dtaps, dbias, dmul, dadd = _std_bwd(corner_mode, with_stats, merged_bwd, fold,
                                                    has_bias, x, taps, act, y, gy, gst, stride)
            return None, None, None, None, None, dx, dtaps, dbias, dmul, dadd


def _std_bwd(corner_mode, with_stats, merged_bwd, fold, has_bias, x, taps, act, y, gy, gst,
             stride=1):
    """The standard conv's backward (JAX's ``conv_kernel._bwd``, the
    ``std`` family): the forward's raw x, taps, act, output y and the
    cotangents of y and its stats -> (dx, dtaps, dbias, d_mul, d_add)."""
    gy, fk = gy.contiguous(), {}
    if with_stats and (fold or merged_bwd):
        fk = dict(y=y, gs=gst.float().contiguous())
    elif with_stats:  # Σg rides the dx kernel with the fold in or out of the kernels
        (gy,) = stats_geff((gy,), (y,), gst.float().contiguous())
    if merged_bwd:
        dx, dtaps, gsum, dmul, dadd = ico_conv_s2s_bwd(
            x, gy, taps, fk.get("y"), fk.get("gs"), corner_mode, act, with_stats, x.dtype,
            stride=stride)
    else:
        dx, dmul, dadd, gsum = ico_conv_s2s_dx(gy, taps, corner_mode, x.dtype, act, x,
                                               emit_gsum=has_bias, stride=stride, **fk)
        dtaps = ico_conv_s2s_dtaps(x, gy, corner_mode, act, stride=stride, **fk)
    return dx, dtaps, gsum.to(taps.dtype) if has_bias else None, dmul, dadd


def fused_ico_conv_s2s(x, taps, bias, subdivisions, corner_mode="average", stride=1, act=None,
                       with_stats=False, merged_bwd: bool = False,
                       kernel_geff: str | None = None):
    """Standard-layout hex conv (B, 5, h, w, C_in) -> (B, 5, h/stride,
    w/stride, C_out), stride 1 or 2, with its hand-written backward.

    bias may be None; act: optional float32 (mul, add) (C_in,) BN-apply +
    ReLU prologue; with_stats: also return the (2, C_out) float32 [Σy, Σy²],
    a differentiable output. The backward kernels give dx (with the act
    adjoint and d_mul, d_add), dtaps rounded to x's dtype, and the bias
    gradient Σg_eff; with ``merged_bwd`` all from one merged kernel.
    kernel_geff: where the stats fold runs (family ``std``, which, as in
    JAX, has no ``fold_ok``). Stride 2 takes the centres of the Pallas
    ``_tap_slice`` (the same kernels over the stride-2 tables); the model
    routes it, as JAX does, to the plain shared-pad conv, and its DownBlocks
    to the phase form (``fused_dual_s2_conv``). ``subdivisions`` keeps the
    JAX signature; the kernels take the level from x's shape."""
    if stride not in (1, 2):
        raise ValueError(f"fused_ico_conv_s2s: stride must be 1 or 2, got {stride}")
    mul, add = act if act is not None else (None, None)
    fold = kernel_geff_enabled("std", kernel_geff)
    return _IcoConv.apply(corner_mode, with_stats, merged_bwd, fold, stride, x.contiguous(), taps,
                          bias, mul, add)


def _affine_vjp(stats, count, gamma, beta, eps, dmul, dadd):
    """(d_stats, d_gamma, d_beta): the VJP of bn00's affine
    (``bn_affine_plain``) at (stats, gamma, beta) for the cotangents of
    (mul, add), by autograd of the (C,)-sized formula."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (stats, gamma, beta)]
        mul, add = bn_affine_plain(leaves[0], count, leaves[1], leaves[2], eps)
        return torch.autograd.grad((mul, add), leaves, (dmul.float(), dadd.float()))


class _UpBlock(torch.autograd.Function):
    """Inputs: settings, x, t00, b00, t10, b10, t01, b01 (biases or None),
    gamma, beta. Outputs: 4 b0 phases, 4 y10 phases, s00, s01, s10."""

    @staticmethod
    def forward(ctx, corner_mode, eps, merged, folds, x, t00, b00, t10, b10, t01, b01, gamma,
                beta):
        with tracing.span("kernel.UpBlock"):
            b0, y10, y00, s00, s01, s10, mul00, add00 = up_block_fwd(
                x, [(t00, b00), (t10, b10), (t01, b01)], gamma, beta, corner_mode, eps)
            ctx.settings = (corner_mode, eps, merged, folds,
                            [b is not None for b in (b00, b10, b01)])
            ctx.save_for_backward(x, t00, t10, t01, gamma, beta, *y00, *y10, *b0, s00, mul00, add00)
            return (*b0, *y10, s00, s01, s10)

    @staticmethod
    def backward(ctx, *g):
        with tracing.span("kernel.UpBlock.bwd"):
            corner_mode, eps, (m_upd, m_pcs1), (f_upd, f_pcs1), has_bias = ctx.settings
            x, t00, t10, t01, gamma, beta, *res = ctx.saved_tensors
            y00, y10, b0, (s00, mul00, add00) = res[:4], res[4:8], res[8:12], res[12:]
            g_s00, g_s01, g_s10 = g[8:]
            # conv01's backward, then the affine's (C,)-sized VJP, whose moments
            # cotangent joins s00's, then the pair's backward (_upblk_bwd)
            d_y00, (dt01,), (db01,), dmul, dadd = _pcs1_bwd(
                corner_mode, True, True, m_pcs1, f_pcs1, has_bias[2:], y00, [t01], (mul00, add00),
                b0, g[:4], [g_s01])
            d_s00, d_gamma, d_beta = _affine_vjp(s00, 4.0 * y00[0].shape[:-1].numel(), gamma, beta,
                                                 eps, dmul, dadd)
            dx, (dt00, dt10), (db00, db10) = _upd_bwd(
                corner_mode, True, m_upd, f_upd, has_bias[:2], x, (t00, t10), (*y00, *y10),
                (*d_y00, *g[4:8]), (d_s00 + g_s00, g_s10))
            return (None,) * 4 + (dx, dt00, db00, dt10, db10, dt01, db01, d_gamma, d_beta)


def fused_up_block(x, t00, b00, t10, b10, t01, b01, gamma, beta, corner_mode="average",
                   fold_ok: bool = True, fold_site: str = "", eps: float = 1e-5,
                   merged_bwd: str | None = None, kernel_geff: str | None = None):
    """A whole UpBlock's training forward in one launch (kernel o), with the
    split route's backward.

    x: (B, 5, h, w, C_in) level-s grid; the taps and biases of conv00,
    conv10 and conv01 in x's dtype; gamma, beta: bn00's float32 scale and
    bias, from which the kernel computes bn00's affine on its own batch
    moments. Returns (b0 4-tuple, y10 4-tuple, s00, s01, s10), the contract
    of ``fused_up_dual_conv`` + bn00's affine + ``fused_phase_conv_s1``.
    The backward recomposes those two Functions' backward programs around
    the affine's VJP (JAX's ``_upblk_bwd``), each in the family JAX names
    (``pcs1_<fold_site>``, ``upd``): merged_bwd (the model option, by
    family), fold_ok and kernel_geff pick their kernels as for the split
    blocks."""
    merged = (merged_bwd_enabled("upd", merged_bwd), merged_bwd_enabled("pcs1", merged_bwd))
    folds = (kernel_geff_enabled("upd", kernel_geff, fold_ok),
             kernel_geff_enabled(f"pcs1_{fold_site}" if fold_site else "pcs1", kernel_geff,
                                 fold_ok))
    r = _UpBlock.apply(corner_mode, eps, merged, folds, x.contiguous(), t00, b00, t10, b10, t01,
                       b01, gamma, beta)
    return tuple(r[:4]), tuple(r[4:8]), *r[8:]


class _DownBlock(torch.autograd.Function):
    """Inputs: settings, 4 phases, t00, b00, t10, b10, t01, b01 (biases or
    None), gamma, beta, act mul, add (or None). Outputs: b0, y10, s00, s01,
    s10."""

    @staticmethod
    def forward(ctx, corner_mode, eps, merged, folds, *tensors):
        with tracing.span("kernel.DownBlock"):
            phases, (t00, b00, t10, b10, t01, b01, gamma, beta, mul, add) = tensors[:4], tensors[4:]
            act = None if mul is None else (mul, add)
            b0, y10, y00, s00, s01, s10, mul00, add00 = dn_block_fwd(
                phases, [(t00, b00), (t10, b10), (t01, b01)], gamma, beta, act, corner_mode, eps)
            ctx.settings = (corner_mode, eps, merged, folds,
                            [b is not None for b in (b00, b10, b01)])
            ctx.save_for_backward(*phases, t00, t10, t01, gamma, beta, mul, add, y00, y10, b0, s00,
                                  mul00, add00)
            return b0, y10, s00, s01, s10

    @staticmethod
    def backward(ctx, g_b0, g_y10, g_s00, g_s01, g_s10):
        with tracing.span("kernel.DownBlock.bwd"):
            corner_mode, eps, (m_ds2, m_std), (f_ds2, f_std), has_bias = ctx.settings
            saved = ctx.saved_tensors
            phases, (t00, t10, t01, gamma, beta, mul, add) = saved[:4], saved[4:11]
            y00, y10, b0, s00, mul00, add00 = saved[11:]
            # conv01's backward, the affine's VJP, then the stride-2 pair's
            # backward (_dnblk_bwd)
            d_y00, dt01, db01, dmul, dadd = _std_bwd(corner_mode, True, m_std, f_std, has_bias[2],
                                                     y00, t01, (mul00, add00), b0, g_b0, g_s01)
            d_s00, d_gamma, d_beta = _affine_vjp(s00, float(y00.shape[:-1].numel()), gamma, beta,
                                                 eps, dmul, dadd)
            dphases, (dt00, dt10), (db00, db10), dmul_in, dadd_in = _ds2_bwd(
                corner_mode, True, True, m_ds2, f_ds2, has_bias[:2], phases, (t00, t10),
                None if mul is None else (mul, add), (y00, y10), (d_y00, g_y10),
                (d_s00 + g_s00, g_s10))
            return (None,) * 4 + (*dphases, dt00, db00, dt10, db10, dt01, db01, d_gamma, d_beta,
                                  dmul_in, dadd_in)


def fused_down_block(xp, t00, b00, t10, b10, t01, b01, gamma, beta, s_in: int, in_act=None,
                     corner_mode="average", fold_ok: bool = True, eps: float = 1e-5,
                     merged_bwd: str | None = None, kernel_geff: str | None = None):
    """A whole DownBlock's training forward in one launch (kernel p), with
    the split route's backward.

    xp: the 4 parity phases of the level-``s_in`` input, each (B, 5, h, w,
    C_in); the taps and biases of conv00, conv10 (stride 2) and conv01 in
    their dtype; gamma, beta: bn00's float32 scale and bias; in_act:
    optional float32 (mul, add) pending prologue. Returns (b0, y10, s00,
    s01, s10) with b0, y10 standard level-(s_in - 1) grids, the contract of
    ``fused_dual_s2_conv`` + bn00's affine + the standard conv01. The
    backward recomposes their backward programs around the affine's VJP
    (JAX's ``_dnblk_bwd``), in the families ``std`` and ``ds2``: merged_bwd,
    fold_ok and kernel_geff pick their kernels as for the split blocks."""
    xp = tuple(p.contiguous() for p in xp)
    if grid_level(xp[0].shape[2], xp[0].shape[3]) + 1 != s_in:
        raise ValueError(f"fused_down_block: phases {tuple(xp[0].shape)} are not of level {s_in}")
    mul, add = in_act if in_act is not None else (None, None)
    merged = (merged_bwd_enabled("ds2", merged_bwd), merged_bwd_enabled("std", merged_bwd))
    folds = (kernel_geff_enabled("ds2", kernel_geff, fold_ok),
             kernel_geff_enabled("std", kernel_geff))
    return _DownBlock.apply(corner_mode, eps, merged, folds, *xp, t00, b00, t10, b10, t01, b01,
                            gamma, beta, mul, add)


class _PairHead(torch.autograd.Function):
    """Inputs: 4 b0 phases, 4 y10 phases, mul1, add1, mul2, add2, W, bias.
    Outputs: the 4 float32 output phases."""

    @staticmethod
    def forward(ctx, *tensors):
        with tracing.span("kernel.PairHead"):
            ctx.save_for_backward(*tensors)
            return pair_head_fwd(tensors[:4], tensors[4:8], tensors[8:12], *tensors[12:])

    @staticmethod
    def backward(ctx, *g):
        with tracing.span("kernel.PairHead.bwd"):
            t = ctx.saved_tensors
            db0, dy10, dW, dbias, *daff = pair_head_bwd(
                tuple(gp.contiguous() for gp in g), t[:4], t[4:8], t[8:12], t[12], t[13])
            return (*db0, *dy10, *daff, dW, dbias)


def fused_pair_head(b0, y10, affines, Wh, bh):
    """Last-UpBlock tail + 1×1 head + tanh in one kernel, with its
    hand-written backward.

    b0, y10: 4-tuples of contiguous (B, 5, h, w, C) phases; affines: float32
    (mul1, add1, mul2, add2) (C,), the pending bn01 / bn10 applies; Wh
    (C, F), bh (F,) in the phases' dtype. Returns the 4 output phases
    (B, 5, h, w, F) float32 with tanh applied (interleave with
    ``phase_merge``). The backward kernel recomputes the head and takes the
    4 phase cotangents as they come (the poles' adjoint is already in
    them); dW and dbias come rounded to Wh's dtype."""
    return _PairHead.apply(*b0, *y10, *affines, Wh, bh)


class _PairHeadMSE(torch.autograd.Function):
    """Inputs: 4 b0 phases, 4 y10 phases, mul1, add1, mul2, add2, W, bias,
    tpack, tpoles. Output: the (B,) float32 per-sample squared error."""

    @staticmethod
    def forward(ctx, *tensors):
        with tracing.span("kernel.PairHeadMSE"):
            b0, y10, affines, (W, bias, tpack, tpoles) = (tensors[:4], tensors[4:8], tensors[8:12],
                                                          tensors[12:])
            ctx.save_for_backward(*tensors)
            return pair_head_mse_fwd(b0, y10, affines, W, bias, tpack, tpoles)

    @staticmethod
    def backward(ctx, g):
        with tracing.span("kernel.PairHeadMSE.bwd"):
            t = ctx.saved_tensors
            W, bias = t[12], t[13]
            db0, dy10, dW, dbias, *daff = pair_head_mse_bwd(
                g.float().contiguous(), t[:4], t[4:8], t[8:12], W, bias, t[14], t[15])
            return (*db0, *dy10, *daff, dW.to(W.dtype), dbias.to(bias.dtype), None, None)


def fused_pair_head_mse(b0, y10, affines, Wh, bh, tpack, tpoles):
    """Last-UpBlock tail + head + tanh + position squared error in one
    kernel, with its hand-written backward.

    b0, y10: 4-tuples of (B, 5, h, w, C) phases; affines: float32 (mul1,
    add1, mul2, add2) (C,), the pending bn01 / bn10 applies; Wh (C, F), bh
    (F,) in the phases' dtype; tpack, tpoles from
    ``ops/vertices.pack_target_phases``. Returns the (B,) float32 per-sample
    squared-error SUM over every vertex coordinate (grid cells and the two
    pole vertices); divide by V·3 for the per-sample MSE. The targets get no
    gradient."""
    return _PairHeadMSE.apply(*b0, *y10, *affines, Wh, bh, tpack.contiguous(),
                              tpoles.contiguous())

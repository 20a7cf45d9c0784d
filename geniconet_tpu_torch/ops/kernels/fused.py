"""The fused convs and the fused head+MSE with their hand-written backward,
as ``torch.autograd.Function``s.

Port of the custom VJPs of ``geniconet_tpu/ops/pallas/phase_kernel.py`` and
``conv_kernel.py``, with their names and arguments:

* ``fused_phase_conv_s1`` (``_pcs1``): 4 phases -> 4 phases, stride 1;
* ``fused_dual_s2_conv``  (``_ds2``): a DownBlock's two stride-2 convs;
* ``fused_up_dual_conv``  (``_upd``): an UpBlock's upsample + two convs;
* ``fused_ico_conv_s2s``  (``_fic``): the standard-layout conv, stride 1
  (a DownBlock's conv01): ``ico_conv_s2s_fwd`` + ``ico_conv_s2s_dx`` /
  ``ico_conv_s2s_dtaps``;
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

The JAX signatures' ``fold_ok`` and ``fold_site`` are left out: they only
choose, on the TPU, whether the fold runs inside the kernels or as an XLA
pass before them (``_stats_geff``, the default for the standard conv). The
math is the same; here it always runs inside, on both routes.
"""

from __future__ import annotations

import torch

from geniconet_tpu_torch.ops.kernels.conv_kernel import (
    ico_conv_s2s_bwd, ico_conv_s2s_dtaps, ico_conv_s2s_dx, ico_conv_s2s_fwd,
)
from geniconet_tpu_torch.ops.kernels.phase_kernel import (
    pair_head_bwd, pair_head_fwd, pair_head_mse_bwd, pair_head_mse_fwd, phase_conv_bwd,
    phase_conv_dtaps, phase_conv_dx, phase_conv_fwd, up_dual_conv_bwd, up_dual_conv_dtaps,
    up_dual_conv_dx, up_dual_conv_fwd,
)

__all__ = ["fused_phase_conv_s1", "fused_dual_s2_conv", "fused_up_dual_conv",
           "fused_ico_conv_s2s", "fused_pair_head", "fused_pair_head_mse"]

_ALL = (0, 1, 2, 3)


def _groups(grads, n_sets, n):
    return [[g.contiguous() for g in grads[s * n : (s + 1) * n]] for s in range(n_sets)]


def _fold_kwargs(with_stats, ys, stat_grads, n_sets, n):
    if not with_stats:
        return {}
    return dict(y_groups=_groups(ys, n_sets, n),
                gs_list=[g.float().contiguous() for g in stat_grads])


class _PhaseConv(torch.autograd.Function):
    """Inputs: the non-tensor settings, then 4 phases, n_sets taps, n_sets
    biases (or None), act mul, add (or None). Outputs: n_sets × n_out
    phases, then n_sets stats when with_stats."""

    @staticmethod
    def forward(ctx, corner_mode, out_phases, n_sets, with_stats, needs_dx, merged_bwd,
                *tensors):
        phases, taps = tensors[:4], tensors[4 : 4 + n_sets]
        biases = tensors[4 + n_sets : 4 + 2 * n_sets]
        mul, add = tensors[4 + 2 * n_sets :]
        act = None if mul is None else (mul, add)
        r = phase_conv_fwd(phases, list(zip(taps, biases)), corner_mode, out_phases, act,
                           with_stats)
        sets, stats = r if with_stats else (r, [])
        outs = [o for group in sets for o in group]
        ctx.settings = (corner_mode, out_phases, n_sets, with_stats, needs_dx, merged_bwd,
                        [b is not None for b in biases])
        ctx.save_for_backward(*phases, *taps, mul, add, *(outs if with_stats else ()))
        return (*outs, *stats)

    @staticmethod
    def backward(ctx, *grads):
        corner_mode, out_phases, n_sets, with_stats, needs_dx, merged_bwd, has_bias = ctx.settings
        saved = ctx.saved_tensors
        phases, taps = saved[:4], saved[4 : 4 + n_sets]
        mul, add = saved[4 + n_sets : 6 + n_sets]
        act = None if mul is None else (mul, add)
        n_out, dt, cin = len(out_phases), phases[0].dtype, phases[0].shape[-1]
        g_groups = _groups(grads, n_sets, n_out)
        fk = _fold_kwargs(with_stats, saved[6 + n_sets :], grads[n_sets * n_out :], n_sets, n_out)
        sets = [(t, None) for t in taps]
        dphases, dmul, dadd, gsums = (None,) * 4, None, None, None
        if needs_dx and merged_bwd:
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
        return (None,) * 6 + (*dphases, *[d.to(t.dtype) for d, t in zip(dtaps, taps)], *dbias,
                              dmul, dadd)


def fused_phase_conv_s1(phases, taps, bias, corner_mode="average", act=None, with_stats=False,
                        needs_dx=True, merged_bwd: bool = False):
    """Stride-1 hex conv in phase form: 4 phases in -> 4 phases out.

    act: optional float32 (mul, add) (C_in,) BN-apply + ReLU prologue.
    with_stats: also return the (2, C_out) float32 [Σy, Σy²] of the output.
    needs_dx=False skips the input-cotangent kernel (for data inputs).
    merged_bwd: the backward as one merged kernel (with needs_dx)."""
    mul, add = act if act is not None else (None, None)
    r = _PhaseConv.apply(corner_mode, _ALL, 1, with_stats, needs_dx, merged_bwd, *phases, taps,
                         bias, mul, add)
    return (tuple(r[:4]), r[4]) if with_stats else tuple(r)


def fused_dual_s2_conv(phases, taps_a, bias_a, taps_b, bias_b, corner_mode="average", act=None,
                       with_stats=False, merged_bwd: bool = False):
    """Both stride-2 convs of a DownBlock in one kernel: the 4 parity phases
    of the level-s input -> (y_a, y_b), standard level-(s-1) tensors
    (output phase 2 of the phase conv) [+ their (2, C) stats]. merged_bwd:
    the backward as one merged kernel."""
    mul, add = act if act is not None else (None, None)
    return _PhaseConv.apply(corner_mode, (2,), 2, with_stats, True, merged_bwd, *phases, taps_a,
                            taps_b, bias_a, bias_b, mul, add)


class _UpDual(torch.autograd.Function):
    """Inputs: settings, x, taps_a, bias_a, taps_b, bias_b. Outputs: 4 + 4
    phases, then 2 stats when with_stats."""

    @staticmethod
    def forward(ctx, corner_mode, with_stats, merged_bwd, x, taps_a, bias_a, taps_b, bias_b):
        r = up_dual_conv_fwd(x, [(taps_a, bias_a), (taps_b, bias_b)], corner_mode, with_stats)
        sets, stats = r if with_stats else (r, [])
        outs = [*sets[0], *sets[1]]
        ctx.settings = (corner_mode, with_stats, merged_bwd, bias_a is not None,
                        bias_b is not None)
        ctx.save_for_backward(x, taps_a, taps_b, *(outs if with_stats else ()))
        return (*outs, *stats)

    @staticmethod
    def backward(ctx, *grads):
        corner_mode, with_stats, merged_bwd, has_a, has_b = ctx.settings
        x, taps_a, taps_b, *ys = ctx.saved_tensors
        g_groups = _groups(grads, 2, 4)
        fk = _fold_kwargs(with_stats, ys, grads[8:], 2, 4)
        sets = [(taps_a, None), (taps_b, None)]
        if merged_bwd:
            dx, dta, dtb, *gsums = up_dual_conv_bwd(x, g_groups, sets, corner_mode, **fk)
        else:
            dx, gsums = up_dual_conv_dx(g_groups, sets, corner_mode, x.dtype,
                                        emit_gsum=has_a or has_b, **fk)
            dta, dtb = up_dual_conv_dtaps(x, g_groups, corner_mode, **fk)
        dba = gsums[0].to(taps_a.dtype) if has_a else None
        dbb = gsums[1].to(taps_b.dtype) if has_b else None
        return None, None, None, dx, dta.to(taps_a.dtype), dba, dtb.to(taps_b.dtype), dbb


def fused_up_dual_conv(x, taps_a, bias_a, taps_b, bias_b, corner_mode="average",
                       with_stats=False, merged_bwd: bool = False):
    """An UpBlock's upsample + both first convs, fused: standard level-s
    (B, 5, h, w, C_in) in -> two 4-tuples of level-(s+1) phases [+ the two
    (2, C_out) stats]. merged_bwd: the backward as one merged kernel."""
    r = _UpDual.apply(corner_mode, with_stats, merged_bwd, x, taps_a, bias_a, taps_b, bias_b)
    out = (tuple(r[0:4]), tuple(r[4:8]))
    return (*out, r[8], r[9]) if with_stats else out


class _IcoConv(torch.autograd.Function):
    """Inputs: settings, x, taps, bias (or None), act mul, add (or None).
    Outputs: y, then its stats when with_stats."""

    @staticmethod
    def forward(ctx, corner_mode, with_stats, merged_bwd, x, taps, bias, mul, add):
        act = None if mul is None else (mul, add)
        r = ico_conv_s2s_fwd(x, taps, bias, corner_mode, act, with_stats)
        y = r[0] if with_stats else r
        ctx.settings = (corner_mode, with_stats, merged_bwd, bias is not None)
        ctx.save_for_backward(x, taps, mul, add, y if with_stats else None)
        return r

    @staticmethod
    def backward(ctx, gy, gst=None):
        corner_mode, with_stats, merged_bwd, has_bias = ctx.settings
        x, taps, mul, add, y = ctx.saved_tensors
        act = None if mul is None else (mul, add)
        gy = gy.contiguous()
        fk = dict(y=y, gs=gst.float().contiguous()) if with_stats else {}
        if merged_bwd:
            dx, dtaps, gsum, dmul, dadd = ico_conv_s2s_bwd(
                x, gy, taps, fk.get("y"), fk.get("gs"), corner_mode, act, with_stats, x.dtype)
        else:
            dx, dmul, dadd, gsum = ico_conv_s2s_dx(gy, taps, corner_mode, x.dtype, act, x,
                                                   emit_gsum=has_bias, **fk)
            dtaps = ico_conv_s2s_dtaps(x, gy, corner_mode, act, **fk)
        dbias = gsum.to(taps.dtype) if has_bias else None
        return None, None, None, dx, dtaps, dbias, dmul, dadd


def fused_ico_conv_s2s(x, taps, bias, subdivisions, corner_mode="average", stride=1, act=None,
                       with_stats=False, merged_bwd: bool = False):
    """Standard-layout hex conv (B, 5, h, w, C_in) -> (B, 5, h, w, C_out),
    stride 1, with its hand-written backward.

    bias may be None; act: optional float32 (mul, add) (C_in,) BN-apply +
    ReLU prologue; with_stats: also return the (2, C_out) float32 [Σy, Σy²],
    a differentiable output. The backward kernels give dx (with the act
    adjoint and d_mul, d_add), dtaps rounded to x's dtype, and the bias
    gradient Σg_eff; with ``merged_bwd`` all from one merged kernel. Stride 2
    runs in phase form (``fused_dual_s2_conv``). ``subdivisions`` keeps the
    JAX signature; the kernels take the level from x's shape."""
    if stride != 1:
        raise ValueError("fused_ico_conv_s2s: stride 1 only; stride 2 is fused_dual_s2_conv")
    mul, add = act if act is not None else (None, None)
    return _IcoConv.apply(corner_mode, with_stats, merged_bwd, x.contiguous(), taps, bias, mul,
                          add)


class _PairHead(torch.autograd.Function):
    """Inputs: 4 b0 phases, 4 y10 phases, mul1, add1, mul2, add2, W, bias.
    Outputs: the 4 float32 output phases."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.save_for_backward(*tensors)
        return pair_head_fwd(tensors[:4], tensors[4:8], tensors[8:12], *tensors[12:])

    @staticmethod
    def backward(ctx, *g):
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
        b0, y10, affines, (W, bias, tpack, tpoles) = (tensors[:4], tensors[4:8], tensors[8:12],
                                                      tensors[12:])
        ctx.save_for_backward(*tensors)
        return pair_head_mse_fwd(b0, y10, affines, W, bias, tpack, tpoles)

    @staticmethod
    def backward(ctx, g):
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

"""The bf16 tensor-core input gradients of the phase conv (a), the up conv
(c), the standard conv (f) and the phase chain's stride-2 conv (m), and the
merged phase-conv backward (i), as their GEMMs formulate them, on the CPU;
and the tables and scratch at the s=5 model shapes.

``_rows_dx`` replays in plain PyTorch what ``csrc/mma_conv_fwd.cuh`` (the
dx GEMM with a's and c's epilogues), ``csrc/mma.cuh:cot_operand_pass`` and
``csrc/up_conv_bwd.cu:up_adjoint_pass`` compute: the written cotangent
(``cot_operand_plain``: per sample the n_out·5hw rows of g_eff, the sets
side by side, then the combined rows, each a weighted sum rounded once; a
zero row after the last sample); GEMM row q = (sample, input phase, cell)
sums, over the taps of its 128-row tile's mask, the operand row that
``halo.phase_dx_codes`` names (a cotangent row, a combined row or the zero
row) times the tap sets packed transposed ((7, Kp, Np): row n of tap t is
column n's set, transposed); then a's epilogues (rounded once; with the
act, the act adjoint against the raw phases and d_mul, d_add) or c's
(float32 dU of the 4 upsampled phases, then ``halo.up_adjoint_table``'s
adjoint, rounded once). Σg_eff is the column sum of the operand's
cotangent rows. It is held against ``phase_conv_dx_plain`` and
``up_dual_conv_dx_plain`` at s=1-4, both corner modes, act on and off, fold
on and off, 1 and 2 tap sets, output phases (0, 1, 2, 3) and (2,), odd
C_in, in float32 (1e-5·max|ref|: only the order of the float32 sums
differs) and bfloat16 (2e-2·max|ref|: the combined rows and the float32
sums round at other points), and against the JAX package's
``fused_phase_conv_s1``, ``fused_dual_s2_conv`` and ``fused_up_dual_conv``
VJPs in Pallas interpret mode at one tiny shape (float32, 1e-5). Inputs
come from numpy seeds.

``_merged_rows_bwd`` replays kernel i's bf16 formulation
(``csrc/phase_conv_bwd.cu:merged_mma``): ONE written cotangent, a's dx
GEMM over its rows and b's dtaps GEMM over the same rows
(``mma::WrittenRows``: the act-applied operand of ``grid_operand_plain``
gathered through ``halo.phase_conv_table`` times the written rows), Σg_eff
their column sums; held against ``phase_conv_bwd_plain`` (1 and 2 sets,
output phases (0, 1, 2, 3) and (2,)) and against ``_phase_conv_bwd``
through the merged VJPs of ``fused_phase_conv_s1`` and
``fused_dual_s2_conv``. ``_split_rows_dx`` replays m's bf16 dx
(``csrc/ds2s.cu``): the written cotangent read from the 4 parity phases by
``split_row``'s map (written here from its shifts and masks, not by
``phase_merge``), then a's (2,) dx GEMM; held against ``ds2s_dx_plain``
and against ``_ds2s_bwd`` through the VJP of ``fused_dual_s2_conv_split``.
Both at s=1-4, both corner modes, act and fold on and off, float32 and
bfloat16, with the tolerances above; the scratch of both at the s=5 sites.

``_pair_rows_dx`` replays kernel n's bf16 dx (``csrc/up_pair.cu``): c's
written cotangent and dU GEMM, the upsample adjoint table's gather, then
the pair tail's adjoint on the unrounded float32 dx against the raw pair,
each level-s cell at its parity phase and row by ``split_row``'s map
(written here from its shifts and masks, not by ``phase_split``): db0,
dy10 rounded once, d_mul1, d_add1 = d_add2, d_mul2 and Σg_eff. Held
against ``up_pair_dx_plain`` at s=1-4, both corner modes, fold on and off,
odd C_in, float32 and bfloat16 (the tolerances above), and against
``_updp_bwd`` through the VJP of ``fused_up_dual_conv_pair`` in interpret
mode (float32, 1e-5); its partial rows at the s=5 sites.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

from geniconet_tpu.ops.pallas import conv_kernel as jck
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch.ops.kernels import build, halo
from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

MODES = ["average", "zeros"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
OUT_PHASES = {"s1": (0, 1, 2, 3), "s2": (2,)}


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _packed_taps_t(tap_sets, cin):
    """The tap sets transposed and stacked along K, as the kernel's pack
    writes them: (7, Kp, Np) float32, row n of tap t = set n // C_out's
    column n % C_out over the C_in channels, zeros past the sets' columns
    and past C_in."""
    cout = tap_sets[0][0].shape[-1]
    ntot = len(tap_sets) * cout
    rows, cols = build.dx_packed_taps_shape(cin, ntot)
    packed = torch.zeros(7, rows // 7, cols)
    for s, (taps, _) in enumerate(tap_sets):
        packed[:, s * cout : (s + 1) * cout, :cin] = taps.float().transpose(1, 2)
    return packed


def _codes(h, w, corner_mode, out_phases):
    """(codes, combined rows, mask, cotangent rows a sample) of the phase
    conv's ``out_phases``, or of the standard conv for None."""
    M = 5 * h * w
    if out_phases is None:
        return (*halo.std_dx_codes(h, w, corner_mode), M)
    return (*halo.phase_dx_codes(h, w, corner_mode, out_phases), len(out_phases) * M)


def _gemm(rows, h, w, corner_mode, out_phases, tap_sets, cin):
    """The dx GEMM over a written operand ``rows`` (as ``cot_operand_plain``
    lays it out): (B, n_in, M, C_in) float32, GEMM row (sample, input phase,
    cell) summing, over the taps of its row tile's mask, the operand row
    the code table names times the transposed taps; n_in = 4 input phases,
    or the standard conv's one grid for ``out_phases=None``."""
    M = 5 * h * w
    codes, comb, mask, n_rows = _codes(h, w, corner_mode, out_phases)
    n_in = codes.shape[0]
    per = n_rows + len(comb[0]) - 1
    B = (rows.shape[0] - 1) // per
    cout = tap_sets[0][0].shape[-1]
    assert rows.shape == build.cot_operand_shape(B, n_rows, per - n_rows, len(tap_sets) * cout)
    code = torch.from_numpy(codes).long()  # (n_in, 7, M): a row, a combined row or ZERO
    assert bool(((code >= 0) | (code == halo.ZERO)).all()) and int(code.max()) < per
    base = (torch.arange(B) * per).view(B, 1, 1, 1)
    idx = torch.where(code >= 0, base + code, torch.tensor(B * per))
    gathered = rows.float()[idx]  # (B, n_in, 7, M, width)
    if mask is not None:  # a row tile reads only its mask's taps
        live = torch.tensor([[(int(m) >> t) & 1 for m in mask] for t in range(7)], dtype=torch.bool)
        live = live.repeat_interleave(128, dim=1).view(7, n_in, M).transpose(0, 1)
        assert not bool(((code != halo.ZERO) & ~live).any())
        gathered = gathered * live[None, ..., None]
    packed = _packed_taps_t(tap_sets, cin)[:, : rows.shape[1]]  # (7, width, Np)
    return torch.einsum("bptmn,tnk->bpmk", gathered, packed)[..., :cin]


def _up_adjoint(acc, h, w, corner_mode):
    """c's second step: the (B, 4, M, C_in) float32 dU gathered through
    ``halo.up_adjoint_table`` into the level-s (B, M, C_in), float32."""
    B, _, M, cin = acc.shape
    offsets, cells, weights = (torch.from_numpy(a) for a in halo.up_adjoint_table(
        h, w, corner_mode))
    seg = torch.repeat_interleave(torch.arange(M), torch.diff(offsets.long()))
    terms = acc.reshape(B, 4 * M, cin)[:, cells.long()] * weights[:, None]
    return torch.zeros(B, M, cin).index_add_(1, seg, terms)


def _rows_dx(g_groups, tap_sets, corner_mode, out_phases, cin, dtype, act=None, raw=None,
             y_groups=None, gs_list=None, up=False):
    """The GEMM's formulation: a's (4 dphases, d_mul, d_add, Σg_eff) or, with
    ``up``, c's (level-s dx, Σg_eff), as ``phase_conv_dx`` and
    ``up_dual_conv_dx`` return them."""
    rows = pk.cot_operand_plain(g_groups, y_groups, gs_list, corner_mode, out_phases)
    return _dx_of_rows(rows, g_groups[0][0].shape, tap_sets, corner_mode, out_phases, cin, dtype,
                       act, raw, y_groups is not None, up)


def _dx_of_rows(rows, g_shape, tap_sets, corner_mode, out_phases, cin, dtype, act=None, raw=None,
                emit_gsum=True, up=False):
    """``_rows_dx`` over a written operand ``rows`` of cotangents of shape
    ``g_shape`` (B, 5, h, w, C_out): the dx GEMM, its epilogue and the
    written rows' Σg_eff (None unless ``emit_gsum``; always with ``up``)."""
    B, _, h, w, cout = g_shape
    M, n_out = 5 * h * w, len(out_phases)
    acc = _gemm(rows, h, w, corner_mode, out_phases, tap_sets, cin)  # (B, 4, M, C_in)
    cot = rows[:-1].view(B, -1, rows.shape[1])[:, : n_out * M].float()
    gsums = [cot[..., s * cout : (s + 1) * cout].sum(dim=(0, 1)) for s in range(len(tap_sets))]
    if up:  # dU of the 4 upsampled phases, then the upsample and level-s pad adjoint
        return _up_adjoint(acc, h, w, corner_mode).to(dtype).view(B, 5, h, w, cin), gsums
    gsums = gsums if emit_gsum else None
    if act is None:
        return tuple(acc[:, p].to(dtype).view(B, 5, h, w, cin) for p in range(4)), None, None, \
            gsums
    mul, add = act
    x = torch.stack([r.float().reshape(B, M, cin) for r in raw], dim=1)
    dm = acc * (x * mul + add > 0.0).float()
    out = (dm * mul).to(dtype)
    return (tuple(out[:, p].view(B, 5, h, w, cin) for p in range(4)),
            (dm * x).sum(dim=(0, 1, 2)), dm.sum(dim=(0, 1, 2)), gsums)


def _std_rows_dx(g, taps, corner_mode, dtype, act=None, raw=None, y=None, gs=None,
                 emit_gsum=False):
    """The GEMM's formulation of the standard conv's dx (f): the written
    cotangent over ``halo.std_dx_codes`` (one input grid), a's epilogues;
    (dx, d_mul, d_add, Σg_eff) as ``ico_conv_s2s_dx`` returns them."""
    fold = dict(y_groups=[[y]], gs_list=[gs]) if y is not None else {}
    rows = pk.cot_operand_plain([[g]], corner_mode=corner_mode, out_phases=None, **fold)
    return _std_dx_of_rows(rows, g.shape, taps, corner_mode, dtype, act, raw, emit_gsum)


def _std_dx_of_rows(rows, g_shape, taps, corner_mode, dtype, act=None, raw=None,
                    emit_gsum=False):
    """``_std_rows_dx`` over a written operand ``rows`` of a cotangent of
    shape ``g_shape`` (B, 5, h, w, C_out)."""
    B, _, h, w, cout = g_shape
    cin = taps.shape[1]
    acc = _gemm(rows, h, w, corner_mode, None, [(taps, None)], cin)[:, 0]  # (B, M, C_in)
    gsum = None
    if emit_gsum:
        gsum = rows[:-1].view(B, -1, rows.shape[1])[:, : 5 * h * w, :cout].float().sum(
            dim=(0, 1))
    if act is None:
        return acc.to(dtype).view(B, 5, h, w, cin), None, None, gsum
    mul, add = act
    x = raw.float().reshape(B, -1, cin)
    dm = acc * (x * mul + add > 0.0).float()
    return ((dm * mul).to(dtype).view(B, 5, h, w, cin), (dm * x).sum(dim=(0, 1)),
            dm.sum(dim=(0, 1)), gsum)


def _close(got, ref, tol):
    got, ref = (t.float() if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.array(t, np.float32)) for t in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= tol * scale, (err, scale)


def _close_tree(got, ref, tol):
    if ref is None:
        assert got is None
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _close_tree(a, b, tol)
    else:
        _close(got, ref, tol)


class _Case:
    """Seeded numpy inputs at level s, B=2: cotangents, their forward outputs
    and stats cotangents, tap sets, act and raw phases."""

    def __init__(self, seed, s, cin, cout, dtype):
        self.r = np.random.RandomState(seed)
        self.h, self.w, self.cin, self.cout, self.dt = 2**s, 2 ** (s + 1), cin, cout, dtype

    def t(self, a, dt=None):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt or self.dt)

    def grid(self, c):
        return self.t(self.r.randn(2, 5, self.h, self.w, c))

    def groups(self, n_sets, n_out):
        return [[self.grid(self.cout) for _ in range(n_out)] for _ in range(n_sets)]

    def gs(self, n_sets):
        return [self.t(1e-3 * self.r.randn(2, self.cout), torch.float32) for _ in range(n_sets)]

    def sets(self, n, cin=None):
        cin = cin or self.cin
        return [(self.t(self.r.randn(7, cin, self.cout) * (7 * cin) ** -0.5), None)
                for _ in range(n)]

    def act(self):
        return (self.t(self.r.uniform(0.5, 1.5, self.cin), torch.float32),
                self.t(0.3 * self.r.randn(self.cin), torch.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride", list(OUT_PHASES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 3, 4), (2, 5, 8), (3, 12, 20), (4, 16, 9)])
def test_rows_dx_is_the_phase_conv_dx(s, cin, cout, corner_mode, stride, dtype):
    """The formulation is ``phase_conv_dx_plain``: dphases, d_mul, d_add and
    Σg_eff, for 1 and 2 tap sets, with the act and the fold on and off."""
    dt, out_phases = DTYPES[dtype], OUT_PHASES[stride]
    c = _Case(10 * s + cin, s, cin, cout, dt)
    n_out = len(out_phases)
    raw = [c.grid(cin) for _ in range(4)]
    for n_sets, with_act, fold in ((1, True, True), (2, False, True), (2, True, False),
                                   (1, False, False)):
        g, sets = c.groups(n_sets, n_out), c.sets(n_sets)
        fk = dict(y_groups=c.groups(n_sets, n_out), gs_list=c.gs(n_sets)) if fold else {}
        act = c.act() if with_act else None
        args = (g, sets, corner_mode, out_phases, cin, dt, act, raw if with_act else None)
        got = _rows_dx(*args, **fk)
        assert all(t.dtype == dt for t in got[0])
        _close_tree(got, pk.phase_conv_dx_plain(*args, **fk), TOL[dt])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 5, 4), (2, 12, 8), (3, 7, 20), (4, 16, 12)])
def test_rows_dx_is_the_up_conv_dx(s, cin, cout, corner_mode, dtype):
    """With c's epilogue (float32 dU, then the upsample adjoint) the
    formulation over the stride-1 tables is ``up_dual_conv_dx_plain``: dx
    and Σg_eff, with the fold and without."""
    dt = DTYPES[dtype]
    c = _Case(50 + 10 * s + cin, s, cin, cout, dt)
    for fold in (True, False):
        g, sets = c.groups(2, 4), c.sets(2)
        fk = dict(y_groups=c.groups(2, 4), gs_list=c.gs(2)) if fold else {}
        got = _rows_dx(g, sets, corner_mode, (0, 1, 2, 3), cin, dt, up=True, **fk)
        assert got[0].dtype == dt
        ref = pk.up_dual_conv_dx_plain(g, sets, corner_mode, dt, emit_gsum=True, **fk)
        _close_tree(got, ref, TOL[dt])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 3, 4), (2, 5, 8), (3, 12, 20), (4, 16, 9)])
def test_rows_dx_is_the_std_conv_dx(s, cin, cout, corner_mode, dtype):
    """Over ``halo.std_dx_codes`` (one input grid; the chart seams and the
    poles as combined rows) the formulation is ``ico_conv_s2s_dx_plain``:
    dx, d_mul, d_add and Σg_eff, with the act and the fold on and off."""
    dt = DTYPES[dtype]
    c = _Case(30 + 10 * s + cin, s, cin, cout, dt)
    raw = c.grid(cin)
    for with_act, fold in ((True, True), (False, True), (True, False), (False, False)):
        g, ((taps, _),) = c.grid(cout), c.sets(1)
        y, gs = (c.grid(cout), c.gs(1)[0]) if fold else (None, None)
        act = c.act() if with_act else None
        args = (g, taps, corner_mode, dt, act, raw if with_act else None, y, gs, fold)
        got = _std_rows_dx(*args)
        assert got[0].dtype == dt
        _close_tree(got, ck.ico_conv_s2s_dx_plain(*args), TOL[dt])


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3])
def test_up_adjoint_is_the_composed_table(s, corner_mode):
    """c's two steps compose to the SIMT kernel's one table: the stride-1
    phase-conv transpose (``phase_dx_table``) followed by
    ``up_adjoint_table`` has the entries and weights of ``up_dx_table``."""
    h, w = 2**s, 2 ** (s + 1)
    M = 5 * h * w

    def csr(offsets, cells, weights, cols):
        return sparse.csr_matrix((weights.astype(np.float64), cells, offsets),
                                 shape=(len(offsets) - 1, cols))

    conv = csr(*halo.phase_dx_table(h, w, corner_mode), 4 * M)  # rows t·4M + u
    adj = csr(*halo.up_adjoint_table(h, w, corner_mode), 4 * M)  # rows r, columns u
    composed = sparse.vstack([adj @ conv[t * 4 * M : (t + 1) * 4 * M] for t in range(7)])
    ref = csr(*halo.up_dx_table(h, w, corner_mode), 4 * M)
    assert abs(composed - ref).max() < 1e-6


def _j(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_j(a) for a in tree)
    return None if tree is None else jnp.asarray(tree.numpy())


def test_rows_dx_matches_pallas(interpret):
    """The formulation against the VJPs of the JAX package's three convs with
    stats in interpret mode, at a level-1 grid, B=2, float32, the fold on:
    ``fused_phase_conv_s1`` with the act (dphases, d_mul, d_add),
    ``fused_dual_s2_conv`` (two sets, output phase 2, with the act) and
    ``fused_up_dual_conv`` (dx), each with its bias gradient Σg_eff."""
    c = _Case(70, 1, 3, 4, torch.float32)
    phases = [c.grid(3) for _ in range(4)]
    (ta, _), (tb, _) = c.sets(2)
    ba, bb = (c.t(c.r.randn(4)) for _ in range(2))
    mul, add = c.act()
    jph, jta, jtb, jba, jbb = _j(phases), *_j([ta, tb, ba, bb])
    jmul, jadd = _j([mul, add])

    def s1(ph, m, a, bias):
        return jpk.fused_phase_conv_s1(ph, jta, bias, "average", act=(m, a), with_stats=True)

    def s2(ph, m, a, b0, b1):
        return jpk.fused_dual_s2_conv(ph, jta, b0, jtb, b1, "average", act=(m, a),
                                      with_stats=True)

    spies = [mock.patch.object(jpk, "_pc_dx_kernel", wraps=jpk._pc_dx_kernel),
             mock.patch.object(jpk, "_up_dx_kernel", wraps=jpk._up_dx_kernel)]
    with spies[0] as pc_spy, spies[1] as up_spy:
        (y, st), vjp = jax.vjp(s1, jph, jmul, jadd, jba)
        g, gs = c.groups(1, 4), c.gs(1)
        dph, dmul, dadd, dbias = vjp((_j(tuple(g[0])), _j(gs[0])))
        got = _rows_dx(g, [(ta, None)], "average", (0, 1, 2, 3), 3, torch.float32, (mul, add),
                       phases, [[torch.from_numpy(np.array(v)) for v in y]], gs)
        _close_tree(got, (dph, dmul, dadd, [dbias]), 1e-5)

        (ya, yb, sa, sb), vjp = jax.vjp(s2, jph, jmul, jadd, jba, jbb)
        g, gs = c.groups(2, 1), c.gs(2)
        dph, dmul, dadd, dba, dbb = vjp((*_j([g[0][0], g[1][0], gs[0], gs[1]]),))
        y = [[torch.from_numpy(np.array(ya))], [torch.from_numpy(np.array(yb))]]
        got = _rows_dx(g, [(ta, None), (tb, None)], "average", (2,), 3, torch.float32,
                       (mul, add), phases, y, gs)
        _close_tree(got, (dph, dmul, dadd, [dba, dbb]), 1e-5)

        x = c.grid(3)
        (ya, yb, sa, sb), vjp = jax.vjp(
            lambda x, b0, b1: jpk.fused_up_dual_conv(x, jta, b0, jtb, b1, "average",
                                                     with_stats=True), _j(x), jba, jbb)
        g, gs = c.groups(2, 4), c.gs(2)
        dx, dba, dbb = vjp((_j(tuple(g[0])), _j(tuple(g[1])), _j(gs[0]), _j(gs[1])))
        y = [[torch.from_numpy(np.array(v)) for v in ys] for ys in (ya, yb)]
        got = _rows_dx(g, [(ta, None), (tb, None)], "average", (0, 1, 2, 3), 3, torch.float32,
                       y_groups=y, gs_list=gs, up=True)
        _close_tree(got, (dx, [dba, dbb]), 1e-5)
    assert pc_spy.call_count >= 2 and up_spy.called


def test_std_rows_dx_matches_pallas(interpret):
    """f's formulation against the VJP of the JAX package's
    ``fused_ico_conv_s2s`` with the act and stats in interpret mode, at a
    level-2 grid, B=2, float32, the fold on: dx, d_mul, d_add and the bias
    gradient Σg_eff."""
    c = _Case(75, 2, 3, 5, torch.float32)
    x, ((taps, _),), bias = c.grid(3), c.sets(1), c.t(c.r.randn(5))
    mul, add = c.act()
    jx, jt, jb, jmul, jadd = _j([x, taps, bias, mul, add])

    def f(x, m, a, b):
        return jck.fused_ico_conv_s2s(x, jt, b, 2, "average", act=(m, a), with_stats=True)

    with mock.patch.object(jck, "_dx_kernel", wraps=jck._dx_kernel) as spy:
        (y, st), vjp = jax.vjp(f, jx, jmul, jadd, jb)
        g, gs = c.grid(5), c.gs(1)[0]
        dx, dmul, dadd, dbias = vjp((_j(g), _j(gs)))
    got = _std_rows_dx(g, taps, "average", torch.float32, (mul, add), x,
                       torch.from_numpy(np.array(y)), gs, True)
    _close_tree(got, (dx, dmul, dadd, dbias), 1e-5)
    assert spy.called


# ---------------------------------------------------------------------------
# i's bf16 formulation: one written cotangent for a's dx and b's dtaps; m's
# dx formulation: the written cotangent read from the parity phases
# ---------------------------------------------------------------------------


def _dtaps_of_rows(rows, raw, act, corner_mode, out_phases, n_sets, cin, cout):
    """b's dtaps GEMM over a written cotangent (``mma::WrittenRows``): per set
    the float32 (7, C_in, C_out) sum over the rows q = (sample, output phase
    slot, cell) of the act-applied operand row (``grid_operand_plain``) that
    ``halo.phase_conv_table`` names for tap t, times the set's columns of
    written row q."""
    B, _, h, w, _ = raw[0].shape
    M, n_out, per = 5 * h * w, len(out_phases), 4 * 5 * h * w + 2
    U = pk.grid_operand_plain(raw, act, corner_mode).float()
    code = torch.from_numpy(halo.phase_conv_table(h, w, corner_mode)).long()[list(out_phases)]
    base = (torch.arange(B) * per).view(B, 1, 1, 1)
    idx = torch.where(code >= 0, base + code,
                      torch.where(code == halo.ZERO, torch.tensor(B * per),
                                  base + per - 2 + (code == halo.SOUTH).long()))
    gathered = U[idx][..., :cin]  # (B, slots, 7, M, C_in)
    G = rows[:-1].view(B, -1, rows.shape[1])[:, : n_out * M].float().view(B, n_out, M, -1)
    return [torch.einsum("bstmk,bsmn->tkn", gathered, G[..., s * cout : (s + 1) * cout])
            for s in range(n_sets)]


def _merged_rows_bwd(raw, g_groups, y_groups, gs_list, tap_sets, corner_mode, out_phases, act,
                     with_stats, dtype):
    """i's bf16 formulation: ONE written cotangent (``cot_operand_plain``,
    folded once), a's dx GEMM and b's dtaps GEMM over its rows, Σg_eff the
    column sums of its cotangent rows; (4 dphases, per-set dtaps, per-set
    Σg_eff, d_mul, d_add) as ``phase_conv_bwd`` returns them."""
    cin, cout = raw[0].shape[-1], g_groups[0][0].shape[-1]
    rows = pk.cot_operand_plain(g_groups, y_groups if with_stats else None, gs_list, corner_mode,
                                out_phases)
    dphases, dmul, dadd, gsums = _dx_of_rows(rows, g_groups[0][0].shape, tap_sets, corner_mode,
                                             out_phases, cin, dtype, act, raw)
    dtaps = _dtaps_of_rows(rows, raw, act, corner_mode, out_phases, len(tap_sets), cin, cout)
    return dphases, dtaps, gsums, dmul, dadd


def _split_rows(groups, h, w):
    """Per set, the (B, 5, h, w, C) stride-2 output grid read from its 4
    parity phases (B, 5, h/2, w/2, C) by ``split_row``'s map: row m =
    (chart, i, j) from phase 2·(i & 1) + (j & 1) at (chart, i >> 1, j >> 1)."""
    m = np.arange(5 * h * w)
    chart, r = m // (h * w), m % (h * w)
    i, j = r // w, r % w
    phase = torch.from_numpy(2 * (i & 1) + (j & 1))
    cell = torch.from_numpy((chart * (h // 2) + (i >> 1)) * (w // 2) + (j >> 1))
    out = []
    for grp in groups:
        B, C = grp[0].shape[0], grp[0].shape[-1]
        stacked = torch.stack([p.reshape(B, -1, C) for p in grp], dim=1)  # (B, 4, cells, C)
        out.append((stacked[:, phase, cell].reshape(B, 5, h, w, C),))
    return out


def _split_rows_dx(g_groups, tap_sets, corner_mode, cin, dtype, act=None, raw=None,
                   y_groups=None, gs_list=None):
    """m's dx formulation: the written cotangent of output phase 2 read from
    the 4 parity phases (``_split_rows``; g and y at the same cell, folded
    once), then a's (2,) dx GEMM and epilogue; (4 dphases, d_mul, d_add,
    Σg_eff) as ``ds2s_dx`` returns them."""
    _, _, hp, wp, _ = g_groups[0][0].shape
    g = _split_rows(g_groups, 2 * hp, 2 * wp)
    y = None if y_groups is None else _split_rows(y_groups, 2 * hp, 2 * wp)
    rows = pk.cot_operand_plain(g, y, gs_list, corner_mode, (2,))
    return _dx_of_rows(rows, g[0][0].shape, tap_sets, corner_mode, (2,), cin, dtype, act, raw,
                       y_groups is not None)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride", list(OUT_PHASES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 3, 4), (2, 5, 8), (3, 12, 20), (4, 16, 9)])
def test_merged_rows_bwd_is_the_phase_conv_bwd(s, cin, cout, corner_mode, stride, dtype):
    """i's formulation is ``phase_conv_bwd_plain``: dphases, each set's
    dtaps and Σg_eff, d_mul and d_add, for 1 and 2 tap sets, with the act
    and the fold on and off."""
    dt, out_phases = DTYPES[dtype], OUT_PHASES[stride]
    c = _Case(110 + 10 * s + cin, s, cin, cout, dt)
    n_out = len(out_phases)
    raw = [c.grid(cin) for _ in range(4)]
    for n_sets, with_act, fold in ((1, True, True), (2, False, True), (2, True, False),
                                   (1, False, False)):
        g, sets = c.groups(n_sets, n_out), c.sets(n_sets)
        y, gs = (c.groups(n_sets, n_out), c.gs(n_sets)) if fold else (None, None)
        args = (raw, g, y, gs, sets, corner_mode, out_phases, c.act() if with_act else None,
                fold, dt)
        got = _merged_rows_bwd(*args)
        assert all(t.dtype == dt for t in got[0])
        assert all(t.dtype == torch.float32 for t in got[1] + got[2])
        _close_tree(got, pk.phase_conv_bwd_plain(*args), TOL[dt])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 3, 4), (2, 5, 8), (3, 12, 20), (4, 16, 9)])
def test_split_rows_dx_is_the_ds2s_dx(s, cin, cout, corner_mode, dtype):
    """m's dx formulation on the level-s input phases (2^s, 2^(s+1)) and the
    level-(s-1) parity phases of the cotangents is ``ds2s_dx_plain`` (the
    plain version merges the phases with ``phase_merge``): dphases, d_mul,
    d_add and Σg_eff, for 1 and 2 tap sets, with the act and the fold on and
    off."""
    dt = DTYPES[dtype]
    c = _Case(150 + 10 * s + cin, s, cin, cout, dt)
    half = _Case(151 + 10 * s + cin, s - 1, cin, cout, dt)  # the cotangents' parity phases
    raw = [c.grid(cin) for _ in range(4)]
    for n_sets, with_act, fold in ((2, True, True), (1, False, True), (2, False, False),
                                   (1, True, False)):
        g, sets = half.groups(n_sets, 4), c.sets(n_sets)
        fk = dict(y_groups=half.groups(n_sets, 4), gs_list=half.gs(n_sets)) if fold else {}
        args = (g, sets, corner_mode, cin, dt, c.act() if with_act else None,
                raw if with_act else None)
        got = _split_rows_dx(*args, **fk)
        assert all(t.dtype == dt and t.shape == raw[0].shape for t in got[0])
        _close_tree(got, pk.ds2s_dx_plain(*args, **fk), TOL[dt])



def _split_map(h, w):
    """``split_row``'s map of a (5, h, w) grid, from its shifts and masks:
    per cell m = (chart, i, j) its parity phase 2·(i & 1) + (j & 1) and its
    cell (chart, i >> 1, j >> 1) of the (5, h/2, w/2) phase."""
    m = np.arange(5 * h * w)
    chart, r = m // (h * w), m % (h * w)
    i, j = r // w, r % w
    return 2 * (i & 1) + (j & 1), (chart * (h // 2) + (i >> 1)) * (w // 2) + (j >> 1)


def _pair_rows_dx(g_groups, b0, y10, affines, tap_sets, corner_mode, y_groups=None,
                  gs_list=None):
    """n's bf16 dx formulation: c's written cotangent of all 4 output phases
    and dU GEMM (``_gemm``), the upsample adjoint's gather (``_up_adjoint``,
    float32, not rounded), then the tail against the raw pair at
    ``_split_map``'s phase and cell: dm = dx·1{((a·mul1 + add1) + b·mul2) +
    add2 > 0}, db0 = dm·mul1 and dy10 = dm·mul2 rounded once into their
    phases, d_mul1 = Σdm·a, d_add1 = d_add2 = Σdm, d_mul2 = Σdm·b; as
    ``up_pair_dx`` returns them (Σg_eff, the written rows' column sums,
    always)."""
    B, _, h, w, cout = g_groups[0][0].shape
    dt, cin = b0[0].dtype, b0[0].shape[-1]
    rows = pk.cot_operand_plain(g_groups, y_groups, gs_list, corner_mode)
    acc = _gemm(rows, h, w, corner_mode, (0, 1, 2, 3), tap_sets, cin)  # (B, 4, M, C_in) dU
    dx = _up_adjoint(acc, h, w, corner_mode)  # (B, M, C_in) float32
    cot = rows[:-1].view(B, -1, rows.shape[1])[:, : 4 * 5 * h * w].float()
    gsums = [cot[..., s * cout : (s + 1) * cout].sum(dim=(0, 1)) for s in range(2)]
    phase, cell = _split_map(h, w)
    p_t, c_t = torch.from_numpy(phase), torch.from_numpy(cell)

    def at_cells(phases):
        return torch.stack([t.float().reshape(B, -1, cin) for t in phases], dim=1)[:, p_t, c_t]

    a, b = at_cells(b0), at_cells(y10)
    mul1, add1, mul2, add2 = affines
    dm = torch.where(a * mul1 + add1 + b * mul2 + add2 > 0, dx, torch.zeros(()))
    db0, dy10 = (dm * mul1).to(dt), (dm * mul2).to(dt)
    shape = b0[0].shape

    def to_phases(t):
        out = []
        for p in range(4):
            sel = np.flatnonzero(phase == p)
            out.append(t[:, sel[np.argsort(cell[sel])]].reshape(shape))
        return tuple(out)

    dadd = dm.sum(dim=(0, 1))
    return (to_phases(db0), to_phases(dy10), (dm * a).sum(dim=(0, 1)), dadd,
            (dm * b).sum(dim=(0, 1)), dadd, gsums)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 5, 4), (2, 12, 8), (3, 7, 20), (4, 16, 12)])
def test_pair_rows_dx_is_the_pair_dx(s, cin, cout, corner_mode, dtype):
    """n's formulation on a level-s pair (parity phases of (2^s, 2^(s+1)))
    is ``up_pair_dx_plain``: the 8 phase cotangents, the 4 affine gradients
    and Σg_eff, with the fold and without."""
    dt = DTYPES[dtype]
    c = _Case(190 + 10 * s + cin, s, cin, cout, dt)
    half = _Case(191 + 10 * s + cin, s - 1, cin, cout, dt)  # the pair's parity phases
    b0, y10 = [half.grid(cin) for _ in range(4)], [half.grid(cin) for _ in range(4)]
    aff = [*c.act(), *c.act()]
    for fold in (True, False):
        g, sets = c.groups(2, 4), c.sets(2)
        fk = dict(y_groups=c.groups(2, 4), gs_list=c.gs(2)) if fold else {}
        got = _pair_rows_dx(g, b0, y10, aff, sets, corner_mode, **fk)
        assert all(t.dtype == dt and t.shape == b0[0].shape for t in got[0] + got[1])
        ref = pk.up_pair_dx_plain(g, b0, y10, aff, sets, corner_mode, emit_gsum=True, **fk)
        _close_tree(got, ref, TOL[dt])

@pytest.fixture
def env(monkeypatch):
    """Set the JAX package's experimental routing variables (read at trace
    time)."""
    def setenv(**values):
        monkeypatch.setenv("GENICONET_EXPERIMENTAL", "1")
        for name, value in values.items():
            monkeypatch.setenv(f"GENICONET_{name}", value)
    return setenv


def test_merged_rows_bwd_matches_pallas(env, interpret):
    """i's formulation against the VJPs of the JAX package's
    ``fused_phase_conv_s1`` (one set, all 4 output phases) and
    ``fused_dual_s2_conv`` (two sets, output phase 2), both with the act and
    stats, whose backward under ``GENICONET_MERGED_BWD=all`` is
    ``_phase_conv_bwd`` in interpret mode, at a level-1 grid, B=2, float32,
    the fold on: dphases, d_mul, d_add, each set's dtaps and bias gradient
    Σg_eff."""
    env(MERGED_BWD="all")
    c = _Case(170, 1, 3, 4, torch.float32)
    phases = [c.grid(3) for _ in range(4)]
    (ta, _), (tb, _) = c.sets(2)
    ba, bb = (c.t(c.r.randn(4)) for _ in range(2))
    mul, add = c.act()
    jph, jta, jtb, jba, jbb, jmul, jadd = _j([phases, ta, tb, ba, bb, mul, add])

    def s1(ph, w, b, m, a):
        return jpk.fused_phase_conv_s1(ph, w, b, "average", act=(m, a), with_stats=True)

    def s2(ph, wa, b0, wb, b1, m, a):
        return jpk.fused_dual_s2_conv(ph, wa, b0, wb, b1, "zeros", act=(m, a), with_stats=True)

    with mock.patch.object(jpk, "_pc_bwd_kernel", wraps=jpk._pc_bwd_kernel) as spy:
        (y, _), vjp = jax.vjp(s1, jph, jta, jba, jmul, jadd)
        g, gs = c.groups(1, 4), c.gs(1)
        dph, dta, dba, dmul, dadd = vjp((_j(tuple(g[0])), _j(gs[0])))
        got = _merged_rows_bwd(phases, g, [[torch.from_numpy(np.array(v)) for v in y]], gs,
                               [(ta, None)], "average", (0, 1, 2, 3), (mul, add), True,
                               torch.float32)
        _close_tree(got, (dph, [dta], [dba], dmul, dadd), 1e-5)

        (ya, yb, _, _), vjp = jax.vjp(s2, jph, jta, jba, jtb, jbb, jmul, jadd)
        g, gs = c.groups(2, 1), c.gs(2)
        dph, dta, dba, dtb, dbb, dmul, dadd = vjp((*_j([g[0][0], g[1][0], gs[0], gs[1]]),))
        y = [[torch.from_numpy(np.array(ya))], [torch.from_numpy(np.array(yb))]]
        got = _merged_rows_bwd(phases, g, y, gs, [(ta, None), (tb, None)], "zeros", (2,),
                               (mul, add), True, torch.float32)
        _close_tree(got, (dph, [dta, dtb], [dba, dbb], dmul, dadd), 1e-5)
    assert spy.call_count >= 2


def test_split_rows_dx_matches_pallas(env, interpret):
    """m's dx formulation against the VJP of the JAX package's
    ``fused_dual_s2_conv_split`` with the act and stats (its ``_ds2s_bwd``,
    the fold in its dx kernel under ``GENICONET_KERNEL_GEFF=ds2``) in
    interpret mode, at a level-2 input grid (level-1 parity phases), B=2,
    float32: dphases, d_mul, d_add and the bias gradients Σg_eff."""
    env(KERNEL_GEFF="ds2")
    c = _Case(175, 2, 3, 4, torch.float32)
    half = _Case(176, 1, 3, 4, torch.float32)
    phases = [c.grid(3) for _ in range(4)]
    (ta, _), (tb, _) = c.sets(2)
    ba, bb = (c.t(c.r.randn(4)) for _ in range(2))
    mul, add = c.act()
    jph, jta, jtb, jba, jbb, jmul, jadd = _j([tuple(phases), ta, tb, ba, bb, mul, add])

    def f(ph, wa, b0, wb, b1, m, a):
        return jpk.fused_dual_s2_conv_split(ph, wa, b0, wb, b1, "average", act=(m, a),
                                            with_stats=True)

    with mock.patch.object(jpk, "_ds2s_dx_kernel", wraps=jpk._ds2s_dx_kernel) as spy:
        outs, vjp = jax.vjp(f, jph, jta, jba, jtb, jbb, jmul, jadd)
        g, gs = half.groups(2, 4), half.gs(2)
        dph, _, dba, _, dbb, dmul, dadd = vjp((*_j([tuple(g[0]), tuple(g[1])]), *_j(gs)))
    y = [[torch.from_numpy(np.array(v)) for v in outs[k]] for k in range(2)]
    got = _split_rows_dx(g, [(ta, None), (tb, None)], "average", 3, torch.float32, (mul, add),
                         phases, y, gs)
    _close_tree(got, (dph, dmul, dadd, [dba, dbb]), 1e-5)
    assert spy.called


def test_pair_rows_dx_matches_pallas(env, interpret):
    """n's dx formulation against the VJP of the JAX package's
    ``fused_up_dual_conv_pair`` with stats (its ``_updp_bwd``, the fold in
    its dx kernel under ``GENICONET_KERNEL_GEFF=upd``) in interpret mode,
    at a level-2 pair (level-1 parity phases), B=2, float32: the 8 phase
    cotangents, the 4 affine gradients and the bias gradients Σg_eff."""
    env(KERNEL_GEFF="upd")
    c = _Case(185, 2, 3, 4, torch.float32)
    half = _Case(186, 1, 3, 4, torch.float32)
    b0, y10 = [half.grid(3) for _ in range(4)], [half.grid(3) for _ in range(4)]
    aff = [*c.act(), *c.act()]
    (ta, _), (tb, _) = c.sets(2)
    ba, bb = (c.t(c.r.randn(4)) for _ in range(2))

    def f(b0, y10, aff, ba, bb):
        return jpk.fused_up_dual_conv_pair(b0, y10, aff, _j(ta), ba, _j(tb), bb, "average",
                                           with_stats=True)

    with mock.patch.object(jpk, "_up_pair_dx_kernel", wraps=jpk._up_pair_dx_kernel) as spy:
        outs, vjp = jax.vjp(f, *_j([tuple(b0), tuple(y10), tuple(aff), ba, bb]))
        g, gs = c.groups(2, 4), c.gs(2)
        db0, dy10, daff, dba, dbb = vjp((*_j([tuple(g[0]), tuple(g[1])]), *_j(gs)))
    y = [[torch.from_numpy(np.array(v)) for v in outs[k]] for k in range(2)]
    got = _pair_rows_dx(g, b0, y10, aff, [(ta, None), (tb, None)], "average", y, gs)
    _close_tree(got, (db0, dy10, *daff, [dba, dbb]), 1e-5)
    assert spy.called


def _std_dtaps_of_rows(rows, x, act, corner_mode, cout, dtype):
    """f's dtaps GEMM over a written cotangent (``mma::WrittenRows``): the
    float32 (7, C_in, C_out) sum over the rows (sample, cell) of the
    act-applied operand row (``grid_operand_plain`` of the one grid) that
    ``halo.std_conv_table`` names for tap t, times written row q's C_out
    columns; rounded to ``dtype`` once (f's chunk sum)."""
    B, _, h, w, cin = x.shape
    M, per = 5 * h * w, 5 * h * w + 2
    U = pk.grid_operand_plain([x], act, corner_mode).float()
    code = torch.from_numpy(halo.std_conv_table(h, w, corner_mode)).long()  # (7, M)
    base = (torch.arange(B) * per).view(B, 1, 1)
    idx = torch.where(code >= 0, base + code,
                      torch.where(code == halo.ZERO, torch.tensor(B * per),
                                  base + per - 2 + (code == halo.SOUTH).long()))
    gathered = U[idx][..., :cin]  # (B, 7, M, C_in)
    G = rows[:-1].view(B, -1, rows.shape[1])[:, :M, :cout].float()
    return torch.einsum("btmk,bmn->tkn", gathered, G).to(dtype)


def _merged_std_rows_bwd(x, g, taps, y, gs, corner_mode, act, with_stats, dtype):
    """k's bf16 formulation (``csrc/ico_conv_bwd.cu:merged_mma``): ONE
    written cotangent (``cot_operand_plain`` over ``halo.std_dx_codes``'
    combined rows, folded once), f's dx GEMM and f's dtaps GEMM over its
    rows, dtaps cast to the dtype, Σg_eff the column sums of its cotangent
    rows; (dx, dtaps, Σg_eff, d_mul, d_add) as ``ico_conv_s2s_bwd`` returns
    them."""
    fold = dict(y_groups=[[y]], gs_list=[gs]) if with_stats else {}
    rows = pk.cot_operand_plain([[g]], corner_mode=corner_mode, out_phases=None, **fold)
    dx, dmul, dadd, gsum = _std_dx_of_rows(rows, g.shape, taps, corner_mode, dtype, act, x, True)
    dtaps = _std_dtaps_of_rows(rows, x, act, corner_mode, g.shape[-1], dtype)
    return dx, dtaps, gsum, dmul, dadd


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 3, 4), (2, 5, 8), (3, 12, 20), (4, 16, 9)])
def test_merged_std_rows_bwd_is_the_std_conv_bwd(s, cin, cout, corner_mode, dtype):
    """k's formulation is ``ico_conv_s2s_bwd_plain``: dx, dtaps in the
    activation dtype, Σg_eff, d_mul and d_add, with the act and the fold on
    and off."""
    dt = DTYPES[dtype]
    c = _Case(180 + 10 * s + cin, s, cin, cout, dt)
    x = c.grid(cin)
    (taps, _), = c.sets(1)
    for with_act, fold in ((True, True), (False, True), (True, False), (False, False)):
        g = c.grid(cout)
        y, gs = (c.grid(cout), c.gs(1)[0]) if fold else (None, None)
        args = (x, g, taps, y, gs, corner_mode, c.act() if with_act else None, fold, dt)
        got = _merged_std_rows_bwd(*args)
        assert got[0].dtype == got[1].dtype == dt and got[2].dtype == torch.float32
        _close_tree(got, ck.ico_conv_s2s_bwd_plain(*args), TOL[dt])


def test_merged_std_rows_bwd_matches_pallas(env, interpret):
    """k's formulation against the VJP of the JAX package's
    ``fused_ico_conv_s2s`` with the act and stats, whose backward under
    ``GENICONET_MERGED_BWD=std`` is ``_std_bwd`` in interpret mode, at a
    level-1 grid, B=2, float32, the fold on: dx, dtaps, the bias gradient
    Σg_eff, d_mul and d_add."""
    env(MERGED_BWD="std")
    c = _Case(185, 1, 3, 4, torch.float32)
    x = c.grid(3)
    (taps, _), = c.sets(1)
    bias = c.t(c.r.randn(4))
    mul, add = c.act()

    def f(x, t, b, m, a):
        return jck.fused_ico_conv_s2s(x, t, b, 1, "average", act=(m, a), with_stats=True)

    with mock.patch.object(jck, "_std_bwd_kernel", wraps=jck._std_bwd_kernel) as spy:
        (y, _), vjp = jax.vjp(f, *_j([x, taps, bias, mul, add]))
        g, gs = c.grid(4), c.gs(1)[0]
        dx, dtaps, dbias, dmul, dadd = vjp(tuple(_j([g, gs])))
    assert spy.called
    got = _merged_std_rows_bwd(x, g, taps, torch.from_numpy(np.array(y)), gs, "average",
                               (mul, add), True, torch.float32)
    _close_tree(got, (dx, dtaps, dbias, dmul, dadd), 1e-5)


# The dx calls of the s=5 models: (cotangent h, w, C_in, C_out, tap sets,
# output phases, up conv), and per sample the combined rows and the active
# (tile, tap) pairs of the 128-row tiles over 7 taps
MODEL_DX = {
    "up0 conv01": (4, 8, 256, 256, 1, (0, 1, 2, 3), False),
    "up1 conv01": (8, 16, 128, 128, 1, (0, 1, 2, 3), False),
    "up2 conv01": (16, 32, 64, 64, 1, (0, 1, 2, 3), False),
    "down0 s2": (16, 32, 64, 128, 2, (2,), False),
    "down1 s2": (8, 16, 128, 256, 2, (2,), False),
    "down2 s2": (4, 8, 256, 256, 2, (2,), False),
    "VAE heads": (4, 8, 256, 512, 2, (2,), False),
    "up0": (4, 8, 256, 256, 2, (0, 1, 2, 3), True),
    "up1": (8, 16, 256, 128, 2, (0, 1, 2, 3), True),
    "up2": (16, 32, 128, 64, 2, (0, 1, 2, 3), True),
    "VAE up0": (4, 8, 512, 256, 2, (0, 1, 2, 3), True),
    # the standard conv's (f; output phases None: its one grid)
    "down0 conv01": (16, 32, 128, 128, 1, None, False),
    "down1 conv01": (8, 16, 256, 256, 1, None, False),
    "down2 conv01": (4, 8, 256, 256, 1, None, False),
}
TABLE_FACTS = {  # (h, w, output phases) -> (combined rows a sample, active / all tap steps)
    (16, 32, (0, 1, 2, 3)): (640, 560, 560), (8, 16, (0, 1, 2, 3)): (320, 140, 140),
    (4, 8, (0, 1, 2, 3)): (160, 35, 35), (16, 32, (2,)): (0, 190, 560),
    (8, 16, (2,)): (0, 55, 140), (4, 8, (2,)): (0, 20, 35),
}


STD_FACTS = {(16, 32): (320, 20), (8, 16): (160, 5), (4, 8): (80, None)}  # (combined, masks)


@pytest.mark.parametrize("key", list(STD_FACTS))
def test_std_code_table_facts_at_s5(key):
    """The standard conv's table at the DownBlocks' conv01 grids: 320, 160,
    80 combined rows a sample (the chart seams, weights (1, 1), and 10 pole
    rows of five 0.2 and two 1), no pole code among the codes (the poles
    are combined rows), every other code one cotangent row or ZERO, and a
    tap mask byte per 128-row tile where 5hw is a multiple of 128 (every
    tap live in every tile), none at (4, 8) where 5hw = 160."""
    h, w = key
    M = 5 * h * w
    n_comb, n_masks = STD_FACTS[key]
    codes, (offsets, cells, weights), mask = halo.std_dx_codes(h, w, "average")
    assert codes.shape == (1, 7, M) and codes.dtype == np.int32
    assert int(codes.min()) == halo.ZERO and int(codes.max()) == M + n_comb - 1
    assert len(offsets) - 1 == n_comb and int(cells.max()) < M
    kinds = {}
    for j in range(n_comb):
        key_w = tuple(sorted(round(float(v), 6) for v in weights[offsets[j] : offsets[j + 1]]))
        kinds[key_w] = kinds.get(key_w, 0) + 1
    assert kinds == {(1.0, 1.0): n_comb - 10, (0.2,) * 5 + (1.0, 1.0): 10}
    if n_masks is None:
        assert mask is None
    else:
        assert len(mask) == n_masks and bool((mask == 0x7F).all())


@pytest.mark.parametrize("key", list(TABLE_FACTS))
def test_code_table_facts_at_s5(key):
    """At the s=5 grids: the stride-1 tables' combined rows (640, 320, 160 a
    sample: seams of weights (1, 1), and 10 pole rows of five 0.2 and two
    1), none at stride 2; the tap steps the masks keep (every one at stride
    1; at stride 2 190 of 560, 55 of 140 and 20 of 35)."""
    h, w, out_phases = key
    n_comb, active, steps = TABLE_FACTS[key]
    codes, (offsets, cells, weights), mask = halo.phase_dx_codes(h, w, "average", out_phases)
    assert codes.shape == (4, 7, 5 * h * w) and codes.dtype == np.int32
    assert len(offsets) - 1 == n_comb
    kinds = {}
    for j in range(n_comb):
        key_w = tuple(sorted(round(float(v), 6) for v in weights[offsets[j] : offsets[j + 1]]))
        kinds[key_w] = kinds.get(key_w, 0) + 1
    if n_comb:
        assert kinds == {(1.0, 1.0): n_comb - 10, (0.2,) * 5 + (1.0, 1.0): 10}
    assert len(mask) * 7 == steps and sum(bin(int(m)).count("1") for m in mask) == active


@pytest.mark.parametrize("site", [k for k, v in MODEL_DX.items() if v[5] is None or len(v[5]) == 4])
def test_combined_rows_move_dx_under_half_an_ulp(site):
    """The one rounding the bf16 GEMM adds: each combined row's weighted sum
    rounded to bf16 once, where the SIMT kernel kept it in float32. The GEMM
    is linear, so that rounding moves the float32 dx (before its last
    rounding) by the GEMM of (rounded - exact combined rows) alone, through
    a's and f's act adjoint or c's upsample adjoint. At every stride-1 site
    of the s=5 models (the phase conv's and the up conv's, and the standard
    conv's at the DownBlocks' conv01; the stride-2 convs have no combined
    rows), B=2, seeded bf16 cotangents with the stats fold, the move stays
    under half a bf16 ulp of max|dx| (2^-8·max|dx|; the card tests hold the
    whole kernel to one)."""
    h, w, cin, cout, n_sets, out_phases, up = MODEL_DX[site]
    std = out_phases is None
    n_in = 1 if std else 4
    c = _Case(90 + cin + std, int(np.log2(h)), cin, cout, torch.bfloat16)
    g, sets = c.groups(n_sets, n_in), c.sets(n_sets)
    g_eff = pk._fold_groups(g, c.groups(n_sets, n_in), c.gs(n_sets))  # bf16, as the pass folds
    phases = None if std else (0, 1, 2, 3)
    exact = pk.cot_operand_plain([[t.float() for t in grp] for grp in g_eff], out_phases=phases)
    rounded = pk.cot_operand_plain(g_eff, out_phases=phases).float()
    exact_b, rounded_b = (r[:-1].view(2, -1, r.shape[1]) for r in (exact, rounded))
    n_rows = n_in * 5 * h * w
    assert torch.equal(rounded_b[:, :n_rows], exact_b[:, :n_rows])  # the cotangent rows
    dx, move = (_gemm(r, h, w, "average", phases, sets, cin) for r in (exact, rounded - exact))
    if up:
        dx, move = _up_adjoint(dx, h, w, "average"), _up_adjoint(move, h, w, "average")
    else:  # the act adjoint is linear in the sums, given the mask
        mul, add = c.act()
        x = torch.stack([c.grid(cin).float().reshape(2, -1, cin) for _ in range(n_in)], dim=1)
        live = (x * mul + add > 0).float() * mul
        dx, move = dx * live, move * live
    ulps = move.abs().max().item() / (2**-7 * dx.abs().max().item())
    print(f"{site}: the combined rows' rounding moves dx by {ulps:.4f} bf16 ulp of max|dx|")
    assert 0 < ulps < 0.5, ulps


@pytest.mark.parametrize("site", list(MODEL_DX))
def test_dx_scratch_at_the_model_shapes(site):
    """``dx_scratch`` at B=36 (bf16): the cotangent operand (cotangent rows
    and combined rows a sample, a zero row; the sets' columns rounded up to
    8), the transposed taps, the act partials a row tile (of the 4 input
    phases' rows, or the standard conv's one grid's), c's float32 dU; and
    the largest (up2: dU 36·4·2560·128·4 B = 189 MB, the operand 100 MB,
    94 of them cotangent rows; f's at down0 conv01: 36·(2560 + 320) + 1
    rows of 128 bf16, 27 MB); float32 takes the SIMT partials and no scratch."""
    h, w, cin, cout, n_sets, out_phases, up = MODEL_DX[site]
    std = out_phases is None
    B, M, ntot = 36, 5 * h * w, n_sets * cout
    n_out, n_in = (1, 1) if std else (len(out_phases), 4)
    n_comb = STD_FACTS[(h, w)][0] if std else TABLE_FACTS[(h, w, out_phases)][0]
    red, operand, wpack, du = pk.dx_scratch(torch.bfloat16, B, h, w, cin, n_sets, cout, n_out,
                                            n_comb, not up, up, "meta", n_in=n_in)
    assert operand.shape == (B * (n_out * M + n_comb) + 1, -(-ntot // 8) * 8)
    assert wpack.shape == (7 * -(-ntot // 32) * 32, -(-cin // 128) * 128)
    assert operand.dtype == wpack.dtype == torch.bfloat16
    if up:
        assert red is None and du.shape == (B, 4, M, cin) and du.dtype == torch.float32
    else:
        assert du is None and red.shape == (-(-B * n_in * M // 128) * 2 * cin,)
    if site == "up2":
        assert du.numel() * 4 == 188_743_680 and operand.numel() * 2 == 100_270_336
    if site == "down0 conv01":
        assert operand.numel() * 2 == 26_542_336
    red, operand, wpack, du = pk.dx_scratch(torch.float32, B, h, w, cin, n_sets, cout, n_out,
                                            n_comb, True, up, "meta", n_in=n_in)
    assert operand is None and wpack is None and du is None
    assert red.shape == (B * build.n_tiles(n_in * M) * 2 * cin,)


@pytest.mark.parametrize("site, blocks", [("up1", 360), ("up2", 1440)])
def test_pair_dx_scratch_at_the_model_shapes(site, blocks):
    """n's bf16 dx at the decoder chain's sites (up1: a (8, 16) pair of 256
    channels, up2: (16, 32) of 128; B=36) takes c's tables and scratch with
    two tap sets (the written cotangent with 320 and 640 combined rows a
    sample, the transposed taps, float32 dU: 189 MB at up2) and one row of
    [d_mul1 | d_add1 | d_mul2] partials a 64 level-s cells of its adjoint
    pass: 360 and 1440 rows."""
    h, w, cin, cout, n_sets, out_phases, _ = MODEL_DX[site]
    B, M = 36, 5 * h * w
    n_comb = TABLE_FACTS[(h, w, out_phases)][0]
    _, operand, wpack, du = pk.dx_scratch(torch.bfloat16, B, h, w, cin, n_sets, cout, 4, n_comb,
                                          False, True, "meta")
    assert operand.shape == build.cot_operand_shape(B, 4 * M, n_comb, n_sets * cout)
    assert wpack.shape == build.dx_packed_taps_shape(cin, n_sets * cout)
    assert du.shape == (B, 4, M, cin) and du.dtype == torch.float32
    assert build.PAIR_ADJOINT_ROWS == 64
    assert build.pair_adjoint_blocks(B, h, w) == blocks == -(-B * M // 64)
    if site == "up2":
        assert du.numel() * 4 == 188_743_680


# i's sites in the s=5 models on the merged route: (h, w, C_in, C_out, tap
# sets, output phases), and per site (combined rows a sample, tap-mask bytes
# a sample or None, rows a dtaps chunk, chunks, NARROW, dtaps blocks, dx
# blocks) of its one launch at B=36
MODEL_I = {
    "up0 conv01": ((4, 8, 256, 256, 1, (0, 1, 2, 3)), (160, 5, 2560, 9, False, 252, 360)),
    "up1 conv01": ((8, 16, 128, 128, 1, (0, 1, 2, 3)), (320, 20, 2496, 37, False, 259, 720)),
    "up2 conv01": ((16, 32, 64, 64, 1, (0, 1, 2, 3)), (640, 80, 5600, 66, True, 264, 2880)),
    "down0 s2": ((16, 32, 64, 128, 2, (2,)), (0, 80, 2816, 33, True, 264, 2880)),
    "down1 s2": ((8, 16, 128, 256, 2, (2,)), (0, 20, 2560, 9, False, 252, 720)),
    "down2 s2": ((4, 8, 256, 256, 2, (2,)), (0, 5, 1440, 4, False, 224, 360)),
    "VAE heads": ((4, 8, 256, 512, 2, (2,)), (0, 5, 2880, 2, False, 224, 360)),
    "chain down0 conv01": ((8, 16, 128, 128, 1, (0, 1, 2, 3)), (320, 20, 2496, 37, False, 259,
                                                                 720)),
    "chain down1 conv01": ((4, 8, 256, 256, 1, (0, 1, 2, 3)), (160, 5, 2560, 9, False, 252, 360)),
    "chain down2 conv01": ((2, 4, 256, 256, 1, (0, 1, 2, 3)), (80, None, 640, 9, False, 252, 90)),
}


@pytest.mark.parametrize("site", list(MODEL_I))
def test_merged_scratch_at_the_model_shapes(site):
    """i's bf16 scratch at B=36 is a's and b's: the written cotangent
    (``dx_scratch``: the n_out·5hw cotangent rows and the combined rows a
    sample, a zero row), the transposed taps and the act partials a row tile
    of the B·4·5hw dx rows; b's act-applied operand of the 4 phases and its
    split (``grid_dtaps_scratch``: 32-row steps, the NARROW tile at a C_in
    of 64, past 32 chunks ``sum_rows``' order). A tap mask a 128-row tile
    wherever 4·5hw is a multiple of 128 (all but the chain's (2, 4)), and
    the one launch's blocks: b's dtaps tiles times the chunks, then a's dx
    tiles. The largest (up2 conv01 and down0's stride-2 conv): the written
    cotangent 50.1 and 47.2 MB, the operand 47.2 MB."""
    (h, w, cin, cout, n_sets, out_phases), facts = MODEL_I[site]
    n_comb, n_masks, kc, n_chunks, narrow, dt_blocks, dx_blocks = facts
    B, M, ntot, n_out = 36, 5 * h * w, n_sets * cout, len(out_phases)
    _, comb, mask = halo.phase_dx_codes(h, w, "average", out_phases)
    assert len(comb[0]) - 1 == n_comb and (mask is None) == (n_masks is None)
    assert mask is None or (len(mask) == n_masks and 4 * M == 128 * n_masks)
    red, operand, wpack, du = pk.dx_scratch(torch.bfloat16, B, h, w, cin, n_sets, cout, n_out,
                                            n_comb, True, False, "meta")
    assert operand.shape == build.cot_operand_shape(B, n_out * M, n_comb, ntot) and du is None
    assert wpack.shape == build.dx_packed_taps_shape(cin, ntot)
    assert red.shape == (-(-B * 4 * M // 128) * 2 * cin,)
    got = pk.grid_dtaps_scratch(torch.bfloat16, B, h, w, cin, ntot, 4, n_out, "meta")
    assert got[:2] == (kc, n_chunks) and kc % 32 == 0
    assert (n_chunks - 1) * kc < B * n_out * M <= n_chunks * kc
    assert got[2].shape == (n_chunks * 7 * cin * ntot,)
    assert got[3].shape == (pk.grid_operand_rows(B, h, w, 4), build.operand_width(cin))
    assert build.mma_narrow(cin) == narrow
    assert build.mma_dtaps_blocks(cin, ntot, narrow) * n_chunks == dt_blocks
    assert -(-cin // 128) * -(-B * 4 * M // 128) == dx_blocks
    if site in ("up2 conv01", "down0 s2"):
        assert operand.numel() * 2 == {"up2 conv01": 50_135_168, "down0 s2": 47_186_432}[site]
        assert got[3].numel() * 2 == 47_195_264


# m's dx sites (the chain's DownBlocks): the input phases' (h, w), C_in,
# C_out, and (cotangent rows, tap-mask bytes, live tap steps) a sample
MODEL_M = {"down0": ((16, 32, 64, 128), (2560, 80, 190)),
           "down1": ((8, 16, 128, 256), (640, 20, 55)),
           "down2": ((4, 8, 256, 256), (160, 5, 20))}


@pytest.mark.parametrize("site", list(MODEL_M))
def test_split_dx_scratch_at_the_model_shapes(site):
    """m's bf16 dx at B=36 takes a's tables and scratch at output phase 2 on
    the input phases' sides (h, w): no combined rows; the written cotangent
    holds a sample's 5hw rows of the merged (h, w) output grid, read from
    the (h/2, w/2) parity phases, both sets side by side (47.2 MB at
    down0); the tap masks keep 190 of 560, 55 of 140 and 20 of 35 tap
    steps."""
    (h, w, cin, cout), (rows, n_masks, live) = MODEL_M[site]
    B, M = 36, 5 * h * w
    codes, comb, mask = halo.phase_dx_codes(h, w, "average", (2,))
    assert M == rows and codes.shape == (4, 7, M) and len(comb[0]) == 1
    assert len(mask) == n_masks and sum(bin(int(m)).count("1") for m in mask) == live
    assert 0 <= int(codes.max()) < M  # every live code one merged cotangent row
    red, operand, wpack, _ = pk.dx_scratch(torch.bfloat16, B, h, w, cin, 2, cout, 1, 0, True,
                                           False, "meta")
    assert operand.shape == (B * M + 1, 2 * cout)
    assert wpack.shape == (7 * 2 * cout, -(-cin // 128) * 128)
    assert red.shape == (B * 4 * M // 128 * 2 * cin,)
    if site == "down0":
        assert operand.numel() * 2 == 47_186_432


# k's sites in the s=5 models on the merged route (the DownBlocks' conv01:
# AE down0-2, VAE down0-1): (h, w, C), and per site (combined rows a sample,
# tap-mask bytes a sample or None, rows a dtaps chunk, chunks, dtaps blocks,
# dx blocks) of its one launch at B=36
MODEL_K = {"down0 conv01": ((16, 32, 128), (320, 20, 2496, 37, 259, 720)),
           "down1 conv01": ((8, 16, 256), (160, 5, 2560, 9, 252, 360)),
           "down2 conv01": ((4, 8, 256), (80, None, 640, 9, 252, 90))}


@pytest.mark.parametrize("site", list(MODEL_K))
def test_merged_std_scratch_at_the_model_shapes(site):
    """k's bf16 scratch at B=36 is f's: the written cotangent
    (``dx_scratch`` with one input grid: the 5hw cotangent rows and the
    combined rows a sample, a zero row), the transposed taps, the act
    partials a row tile of the B·5hw dx rows; f's act-applied operand of the
    one grid and f's split (``grid_dtaps_split``: 32-row steps, the wide
    tile at C_in 128 and 256), not ``build.merged_scratch``' 16-row one (its
    chunks sum in another order). A tap mask byte a 128-row tile where 5hw
    is a multiple of 128, none at (4, 8), and the one launch's blocks: f's
    dtaps tiles times the chunks, then f's dx tiles (90 at (4, 8): under one
    wave of 132 SMs)."""
    (h, w, c), (n_comb, n_masks, kc, n_chunks, dt_blocks, dx_blocks) = MODEL_K[site]
    B, M = 36, 5 * h * w
    _, comb, mask = halo.std_dx_codes(h, w, "average")
    assert len(comb[0]) - 1 == n_comb and (mask is None) == (n_masks is None)
    assert mask is None or len(mask) * 128 == M == 128 * n_masks
    red, operand, wpack, du = pk.dx_scratch(torch.bfloat16, B, h, w, c, 1, c, 1, n_comb, True,
                                            False, "meta", n_in=1)
    assert operand.shape == build.cot_operand_shape(B, M, n_comb, c) and du is None
    assert wpack.shape == build.dx_packed_taps_shape(c, c)
    assert red.shape == (-(-B * M // 128) * 2 * c,)
    got = pk.grid_dtaps_scratch(torch.bfloat16, B, h, w, c, c, 1, 1, "meta")
    assert got[:2] == (kc, n_chunks) == build.grid_dtaps_split(B * M, c, c) and kc % 32 == 0
    assert got[:2] != build.merged_scratch(B * M, c, c, "meta")[:2]
    assert got[2].shape == (n_chunks * 7 * c * c,)
    assert got[3].shape == (pk.grid_operand_rows(B, h, w, 1), build.operand_width(c))
    assert not build.mma_narrow(c)
    assert build.mma_dtaps_blocks(c, c, False) * n_chunks == dt_blocks
    assert -(-c // 128) * -(-B * M // 128) == dx_blocks

"""The bf16 tensor-core forward of the grid convs (the phase conv's and the
standard conv's), as its GEMM formulates it, on the CPU: the act-applied
operand (``grid_operand_plain``), its rows gathered through the conv table
of each output phase slot, times the taps packed side by side, plus the
bias; and the work split at the grid convs' model shapes
(``build.mma_fwd_grid``, ``build.packed_taps_shape``, ``fwd_scratch``).

``_rows_fwd`` replays in plain PyTorch what ``csrc/mma_conv_fwd.cuh``
computes for ``phase_conv_fwd`` and ``ico_conv_s2s_fwd``: output row q =
(sample b, output phase slot, cell m) over n_out slots from out_phase0 is
sum_t U[row_t(q)] @ W[t] + bias, where ``row_t`` reads
``halo.phase_conv_table`` at output phase out_phase0 + slot (or
``halo.std_conv_table``): a cell of the sample's n_src·5hw operand cells,
NORTH / SOUTH its two pole rows after them, ZERO the zero row after the
last sample; W is the tap sets packed into (7·Kp, Np), zeros past C_in and
past the columns. Its outputs are cast to the dtype and its stats are taken
of the cast outputs. It is held against the wrappers' plain versions
(``phase_conv_fwd_plain``, ``ico_conv_s2s_fwd_plain``: the act prologue,
the phase pad or ``ico_pad``, the conv) at s=1-4, both corner modes, with
and without act, 1 and 2 tap sets, output phases (0, 1, 2, 3) and (2,),
C_in 3, 5, 12 and 16, in float32 (1e-5·max|ref|: only the order of the
float32 sums differs) and bfloat16 (2e-2·max|ref|: the float32 sums round
to bf16 at different points), and against the JAX package's
``fused_phase_conv_s1``, ``fused_dual_s2_conv`` and ``fused_ico_conv_s2s``
in Pallas interpret mode at one tiny shape (float32, 1e-5). Inputs come
from numpy seeds.

``_split_rows_fwd`` replays m's bf16 forward (``csrc/ds2s.cu``): ``_rows_fwd``
at output phase 2, then the split store (``SplitFwdEpi``), written here
from ``split_row``'s shifts and masks (not by ``phase_split``): row m =
(chart, i, j) of the (5, 2^lh, 2^lw) output grid to parity phase 2·(i & 1)
+ (j & 1) at row ((b·5 + chart)·2^(lh-1) + (i >> 1))·2^(lw-1) + (j >> 1).
It is held against ``ds2s_fwd_plain`` and against the JAX package's
``fused_dual_s2_conv_split`` forward in interpret mode; ``fwd_scratch`` at
m's s=5 sites.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _packed_taps(tap_sets, cin):
    """The tap sets side by side, as the kernel's tap pack writes them: row
    t·Kp + k, column set·C_out + c, zeros past C_in and past the columns;
    float32 (the pack copies the dtype's values)."""
    cout = tap_sets[0][0].shape[-1]
    rows, cols = build.packed_taps_shape(cin, len(tap_sets) * cout)
    packed = torch.zeros(7, rows // 7, cols)
    for s, (taps, _) in enumerate(tap_sets):
        packed[:, :cin, s * cout : (s + 1) * cout] = taps.float()
    return packed


def _codes(h, w, corner_mode, out_phases):
    """(slots, 7, M) conv-table codes of the GEMM's output phase slots: the
    phase conv's out_phases, or (None) the standard conv's one table."""
    if out_phases is None:
        return torch.from_numpy(halo.std_conv_table(h, w, corner_mode)).long()[None]
    table = torch.from_numpy(halo.phase_conv_table(h, w, corner_mode)).long()
    return table[list(out_phases)]


def _rows_fwd(rows, B, h, w, n_src, tap_sets, corner_mode, out_phases, dtype):
    """The GEMM's formulation: ``rows`` the (B·(n_src·5hw + 2) + 1, width)
    operand; per set the output phase slots (B, 5, h, w, C_out) in
    ``dtype``, and per set the [Σy, Σy²] of the cast outputs."""
    M, width = 5 * h * w, rows.shape[1]
    cin, cout = tap_sets[0][0].shape[1], tap_sets[0][0].shape[-1]
    per = n_src * M + 2
    code = _codes(h, w, corner_mode, out_phases)
    base = (torch.arange(B) * per).view(B, 1, 1, 1)
    idx = torch.where(code >= 0, base + code,
                      torch.where(code == halo.ZERO, torch.tensor(B * per),
                                  base + per - 2 + (code == halo.SOUTH).long()))
    gathered = rows.float()[idx]  # (B, slots, 7, M, width)
    packed = _packed_taps(tap_sets, cin)[:, :width]  # (7, width, Np)
    acc = torch.einsum("bstmk,tkn->bsmn", gathered, packed)
    slots = code.shape[0]
    sets, stats = [], []
    for s, (_, bias) in enumerate(tap_sets):
        y = acc[..., s * cout : (s + 1) * cout]
        if bias is not None:
            y = y + bias.float()
        y = y.to(dtype).reshape(B, slots, 5, h, w, cout)
        sets.append(tuple(y[:, p] for p in range(slots)))
        stats.append(pk.stats_plain(sets[-1]))
    return sets, stats


def _close(got, ref, tol):
    got, ref = (t.float() if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.array(t, np.float32)) for t in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= tol * scale, (err, scale)


def _close_tree(got, ref, tol):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _close_tree(a, b, tol)
    else:
        _close(got, ref, tol)


class _Case:
    """Seeded numpy inputs at level s, B=2: grids, tap sets, act."""

    def __init__(self, seed, s, cin, cout, dtype):
        self.r = np.random.RandomState(seed)
        self.h, self.w, self.cin, self.cout, self.dt = 2**s, 2 ** (s + 1), cin, cout, dtype

    def t(self, a, dt=None):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt or self.dt)

    def grid(self):
        return self.t(self.r.randn(2, 5, self.h, self.w, self.cin))

    def sets(self, n):
        return [(self.t(self.r.randn(7, self.cin, self.cout) * (7 * self.cin) ** -0.5),
                 self.t(self.r.randn(self.cout))) for _ in range(n)]

    def act(self):
        return (self.t(self.r.uniform(0.5, 1.5, self.cin), torch.float32),
                self.t(0.3 * self.r.randn(self.cin), torch.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride", list(OUT_PHASES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 3, 4), (2, 5, 6), (3, 12, 20), (4, 16, 9)])
def test_rows_fwd_is_the_phase_conv(s, cin, cout, corner_mode, stride, dtype):
    """The gathered-rows GEMM on ``grid_operand_plain`` of the 4 phases is
    ``phase_conv_fwd_plain``, outputs and stats: 1 and 2 tap sets (the
    second without a bias), with and without the act prologue."""
    dt, out_phases = DTYPES[dtype], OUT_PHASES[stride]
    c = _Case(10 * s + cin, s, cin, cout, dt)
    phases = [c.grid() for _ in range(4)]
    sets = c.sets(2)
    sets[1] = (sets[1][0], None)
    for tap_sets, act in ((sets[:1], c.act()), (sets, None), (sets, c.act())):
        rows = pk.grid_operand_plain(phases, act, corner_mode)
        got = _rows_fwd(rows, 2, c.h, c.w, 4, tap_sets, corner_mode, out_phases, dt)
        ref = pk.phase_conv_fwd_plain(phases, tap_sets, corner_mode, out_phases, act, True)
        assert all(o.dtype == dt for group in got[0] for o in group)
        _close_tree(got, ref, TOL[dt])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 5, 4), (2, 3, 6), (3, 16, 20), (4, 12, 8)])
def test_rows_fwd_is_the_std_conv(s, cin, cout, corner_mode, dtype):
    """The same GEMM on ``grid_operand_plain`` of the one grid, through the
    standard conv's table, is ``ico_conv_s2s_fwd_plain``, output and stats,
    with and without the act prologue and the bias."""
    dt = DTYPES[dtype]
    c = _Case(60 + 10 * s + cin, s, cin, cout, dt)
    x = c.grid()
    (taps, bias), = c.sets(1)
    for b, act in ((bias, c.act()), (None, None)):
        rows = pk.grid_operand_plain([x], act, corner_mode)
        (got,), (st,) = _rows_fwd(rows, 2, c.h, c.w, 1, [(taps, b)], corner_mode, None, dt)
        ref, ref_st = ck.ico_conv_s2s_fwd_plain(x, taps, b, corner_mode, act, True)
        assert got[0].dtype == dt
        _close_tree((got[0], st), (ref, ref_st), TOL[dt])


def _j(*arrs):
    return [None if a is None else jnp.asarray(a.numpy()) for a in arrs]


def test_rows_fwd_matches_pallas_interpret(interpret):
    """The formulation against the JAX package's three grid forwards with
    stats in interpret mode, at a level-1 grid, B=2, float32, act on:
    ``fused_phase_conv_s1`` (4 output phases, ``_phase_conv_fwd``),
    ``fused_dual_s2_conv`` (two sets, output phase 2) and
    ``fused_ico_conv_s2s`` (``_pallas_forward``)."""
    c = _Case(70, 1, 3, 4, torch.float32)
    phases = [c.grid() for _ in range(4)]
    (ta, ba), (tb, bb) = c.sets(2)
    act = c.act()
    jact = tuple(_j(*act))
    with mock.patch.object(jpk, "_pc_fwd_kernel", wraps=jpk._pc_fwd_kernel) as spy:
        y, st = jpk.fused_phase_conv_s1(_j(*phases), *_j(ta, ba), "average", act=jact,
                                        with_stats=True)
        ya, yb, sa, sb = jpk.fused_dual_s2_conv(_j(*phases), *_j(ta, ba, tb, bb), "average",
                                                act=jact, with_stats=True)
    assert spy.call_count >= 2
    rows = pk.grid_operand_plain(phases, act)
    got = _rows_fwd(rows, 2, 2, 4, 4, [(ta, ba)], "average", (0, 1, 2, 3), torch.float32)
    _close_tree(got, ([tuple(y)], [st]), 1e-5)
    got = _rows_fwd(rows, 2, 2, 4, 4, [(ta, ba), (tb, bb)], "average", (2,), torch.float32)
    _close_tree(got, ([(ya,), (yb,)], [sa, sb]), 1e-5)
    x = c.grid()
    with mock.patch.object(jck, "_kernel", wraps=jck._kernel) as spy:
        y, st = jck.fused_ico_conv_s2s(*_j(x, ta, ba), 1, "average", act=jact, with_stats=True)
    assert spy.called
    (got,), (got_st,) = _rows_fwd(pk.grid_operand_plain([x], act), 2, 2, 4, 1, [(ta, ba)],
                                  "average", None, torch.float32)
    _close_tree((got[0], got_st), (y, st), 1e-5)


# The grid convs' forward calls of the s=5 models: (h, w of the phases or
# grid, C_in, C_out, tap sets, output phases or None for the standard conv)
MODEL_FWD = {
    "conv_in": (16, 32, 3, 64, 1, (0, 1, 2, 3)),
    "down0 s2": (16, 32, 64, 128, 2, (2,)),
    "down1 s2": (8, 16, 128, 256, 2, (2,)),
    "down2 s2": (4, 8, 256, 256, 2, (2,)),
    "VAE heads": (4, 8, 256, 512, 2, (2,)),
    "up0 conv01": (4, 8, 256, 256, 1, (0, 1, 2, 3)),
    "up1 conv01": (8, 16, 128, 128, 1, (0, 1, 2, 3)),
    "up2 conv01": (16, 32, 64, 64, 1, (0, 1, 2, 3)),
    "down0 conv01": (16, 32, 128, 128, 1, None),
    "down1 conv01": (8, 16, 256, 256, 1, None),
    "down2 conv01": (4, 8, 256, 256, 1, None),
}


@pytest.mark.parametrize("B", [1, 16, 36])
@pytest.mark.parametrize("site", list(MODEL_FWD))
def test_grid_fwd_split_at_the_model_shapes(site, B):
    """The tensor-core forward's grid at each model site (B=1 decode, B=16
    serving, B=36 training): Q = B·n_out·5hw rows in 128-row tiles, the
    columns of the sets side by side in 128-column tiles; and
    ``fwd_scratch``'s bf16 operand, packed taps and stats partials (one row
    a row tile), float32's partials (a row per 64-row tile of each sample
    and output phase) and no scratch."""
    h, w, cin, cout, n_sets, out_phases = MODEL_FWD[site]
    n_src, n_out = (1, 1) if out_phases is None else (4, len(out_phases))
    rows, ntot = B * n_out * 5 * h * w, n_sets * cout
    cols, row_tiles = build.mma_fwd_grid(rows, ntot)
    assert cols == -(-ntot // 128) and (row_tiles - 1) * 128 < rows <= row_tiles * 128
    stats, ws, operand, wpack = pk.fwd_scratch(torch.bfloat16, B, h, w, cin, n_sets, cout,
                                               n_src, n_out, True, "meta")
    assert operand.shape == (pk.grid_operand_rows(B, h, w, n_src), build.operand_width(cin))
    assert operand.dtype == wpack.dtype == torch.bfloat16
    assert wpack.shape == build.packed_taps_shape(cin, ntot)
    assert ws.shape == (row_tiles * 2 * ntot,) and len(stats) == n_sets
    assert all(t.shape == (2, cout) and t.dtype == torch.float32 for t in stats)
    stats, ws, operand, wpack = pk.fwd_scratch(torch.float32, B, h, w, cin, n_sets, cout,
                                               n_src, n_out, True, "meta")
    assert operand is None and wpack is None
    assert ws.shape == (B * n_out * build.n_tiles(5 * h * w) * 2 * ntot,)
    (none,), no_ws, _, _ = pk.fwd_scratch(torch.bfloat16, B, h, w, cin, n_sets, cout, n_src,
                                          n_out, False, "meta")
    assert none is None and no_ws is None


# ---------------------------------------------------------------------------
# m's forward: the phase conv's GEMM at output phase 2 with the split store
# ---------------------------------------------------------------------------


def _split_store(y, lh, lw):
    """The split store of one set's (B, 5, 2^lh, 2^lw, C) output grid, from
    ``split_row``'s shifts and masks: its 4 parity phases (B, 5, 2^(lh-1),
    2^(lw-1), C); every phase row written exactly once."""
    B, C = y.shape[0], y.shape[-1]
    m = torch.arange(5 << (lh + lw))
    chart, r = m >> (lh + lw), m & ((1 << (lh + lw)) - 1)
    i, j = r >> lw, r & ((1 << lw) - 1)
    phase = ((i & 1) << 1) | (j & 1)
    b = torch.arange(B)[:, None]
    row = ((((b * 5 + chart) << (lh - 1)) + (i >> 1)) << (lw - 1)) + (j >> 1)  # (B, M)
    n_rows = B * 5 << (lh - 1 + lw - 1)
    out = torch.zeros(4, n_rows, C, dtype=y.dtype)
    hits = torch.zeros(4, n_rows, dtype=torch.long)
    phase = phase.expand(B, -1)
    out[phase, row] = y.reshape(B, -1, C)
    hits.index_put_((phase, row), torch.ones_like(row), accumulate=True)
    assert bool((hits == 1).all())
    hp, wp = 1 << (lh - 1), 1 << (lw - 1)
    return tuple(out[p].view(B, 5, hp, wp, C) for p in range(4))


def _split_rows_fwd(rows, B, h, w, tap_sets, corner_mode, dtype):
    """m's formulation: ``_rows_fwd`` over the 4 input phases at output phase
    2, each set's (B, 5, h, w) output stored by the split map; per set the
    4 parity phases and the [Σy, Σy²] of the cast outputs."""
    sets, stats = _rows_fwd(rows, B, h, w, 4, tap_sets, corner_mode, (2,), dtype)
    lh, lw = h.bit_length() - 1, w.bit_length() - 1
    return [_split_store(y, lh, lw) for (y,) in sets], stats


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(2, 5, 6), (3, 12, 20), (4, 16, 9)])
def test_split_rows_fwd_is_the_ds2s_fwd(s, cin, cout, corner_mode, dtype):
    """m's formulation on the level-(s+1) input phases (2^s, 2^(s+1)) is
    ``ds2s_fwd_plain`` (the plain version splits with ``phase_split``):
    each set's 4 parity phases and stats, for 1 and 2 tap sets (the second
    without a bias), with and without the act prologue."""
    dt = DTYPES[dtype]
    c = _Case(200 + 10 * s + cin, s, cin, cout, dt)
    phases = [c.grid() for _ in range(4)]
    sets = c.sets(2)
    sets[1] = (sets[1][0], None)
    for tap_sets, act in ((sets[:1], c.act()), (sets, None), (sets, c.act())):
        rows = pk.grid_operand_plain(phases, act, corner_mode)
        got = _split_rows_fwd(rows, 2, c.h, c.w, tap_sets, corner_mode, dt)
        ref = pk.ds2s_fwd_plain(phases, tap_sets, corner_mode, act, True)
        assert all(p.dtype == dt and p.shape == (2, 5, c.h // 2, c.w // 2, cout)
                   for group in got[0] for p in group)
        _close_tree(got, ref, TOL[dt])


def test_split_rows_fwd_matches_pallas(interpret):
    """m's formulation against the JAX package's ``fused_dual_s2_conv_split``
    with the act and stats (``_ds2s``) in interpret mode, at level-2 input
    phases (4, 8), B=2, float32: both sets' 4 parity phases and stats."""
    c = _Case(230, 2, 3, 4, torch.float32)
    phases = [c.grid() for _ in range(4)]
    (ta, ba), (tb, bb) = c.sets(2)
    act = c.act()
    with mock.patch.object(jpk, "_ds2s_fwd_kernel", wraps=jpk._ds2s_fwd_kernel) as spy:
        ya, yb, sa, sb = jpk.fused_dual_s2_conv_split(
            tuple(_j(*phases)), *_j(ta, ba, tb, bb), "average", act=tuple(_j(*act)),
            with_stats=True)
    assert spy.called
    rows = pk.grid_operand_plain(phases, act)
    got = _split_rows_fwd(rows, 2, 4, 8, [(ta, ba), (tb, bb)], "average", torch.float32)
    _close_tree(got, ([tuple(ya), tuple(yb)], [sa, sb]), 1e-5)


# m's forward sites in the s=5 chains: the input phases' (h, w), C_in, C_out
MODEL_M_FWD = {"down0": (16, 32, 64, 128), "down1": (8, 16, 128, 256),
               "down2": (4, 8, 256, 256)}


@pytest.mark.parametrize("B", [1, 16, 36])
@pytest.mark.parametrize("site", list(MODEL_M_FWD))
def test_split_fwd_scratch_at_the_model_shapes(site, B):
    """m's bf16 forward at each chain site (B=1 and 16 serving, B=36
    training) takes the phase conv's scratch at output phase 2
    (``fwd_scratch`` with 4 sources and 1 output slot): the operand of the 4
    input phases, both tap sets packed side by side, a stats row a 128-row
    tile of the B·5hw rows. At down2 (M = 160) the tiles straddle samples
    wherever B > 1, and every tile there spans 4 charts (5hw / 5 = 32 rows
    a chart): the split map is per row."""
    h, w, cin, cout = MODEL_M_FWD[site]
    M, ntot = 5 * h * w, 2 * cout
    stats, ws, operand, wpack = pk.fwd_scratch(torch.bfloat16, B, h, w, cin, 2, cout, 4, 1, True,
                                               "meta")
    cols, row_tiles = build.mma_fwd_grid(B * M, ntot)
    assert (cols, row_tiles) == (-(-ntot // 128), -(-B * M // 128))
    assert operand.shape == (pk.grid_operand_rows(B, h, w, 4), build.operand_width(cin))
    assert wpack.shape == build.packed_taps_shape(cin, ntot)
    assert ws.shape == (row_tiles * 2 * ntot,) and [t.shape for t in stats] == [(2, cout)] * 2
    straddle = sum((t * 128) // M != (min((t + 1) * 128, B * M) - 1) // M
                   for t in range(row_tiles))
    assert (straddle > 0) == (M % 128 != 0 and B > 1)
    assert (h * w >= 128) == (site != "down2")

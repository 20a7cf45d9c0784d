"""The standard conv at stride 2 (s -> s-1) against the JAX package, on the CPU.

* The plain versions (the wrappers' CPU route) of the forward with the act
  and the stats, dx, dtaps and the merged backward, against the Pallas
  ``_pallas_forward``, ``_pallas_dx``, ``_pallas_dtaps`` and ``_std_bwd`` at
  ``stride=2`` in interpret mode (s=2 and 3, both corner modes, act and the
  stats fold on and off, four of the eight mixes): float32, 1e-5·max|ref| (only the order of the
  float32 sums differs).
* ``fused_ico_conv_s2s(..., stride=2)`` (the port's Function, split and
  merged backward, the fold in and out of the kernels; s=2, both corner
  modes among them) against the JAX op and ``jax.grad`` of it, as tests/test_pallas_conv.py runs them: the
  output and stats at rtol 1e-4 / atol 1e-5, dx, dtaps, dbias, d_mul and
  d_add at rtol 1e-4 / atol 1e-4.
* The stride-2 tables: ``std_conv_table(stride=2)`` names, cell for cell,
  what the phase conv's table names at output phase 2 over the grid's
  parity phases (the two convs are one function); ``std_dx_table`` is its
  adjoint; ``std_dx_codes``' facts at the s=5 DownBlock grids.
* The kernels' index arithmetic replayed in plain PyTorch (the operand
  rows named by the forward table, per sample 5hw input cells and 2 poles;
  the dx GEMM's 5hw input rows a sample reading the written cotangent's
  5hw/4 rows through the code table; the dtaps over the 5hw/4 output rows),
  against the plain versions in float32 and bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.ops.pallas import conv_kernel as jck
from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
from geniconet_tpu_torch.ops.kernels import fused, halo
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

MODES = ["average", "zeros"]
FOLDS = [(True, True), (True, False), (False, True), (False, False)]  # (act, fold)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _close(got, ref, tol=1e-5):
    if ref is None:
        assert got is None
        return
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref.float() if isinstance(ref, torch.Tensor) else ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def j(a):
    return None if a is None else jax.tree.map(jnp.asarray, a)


def t(a):
    return None if a is None else jax.tree.map(lambda v: torch.from_numpy(np.array(v)), a)


class _Case:
    def __init__(self, seed):
        self.r = np.random.RandomState(seed)

    def arr(self, *shape, scale=1.0):
        return (scale * self.r.randn(*shape)).astype(np.float32)

    def act(self, c):
        return self.r.uniform(0.5, 1.5, c).astype(np.float32), self.arr(c, scale=0.3)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s, corner_mode, with_act, fold", [
    (2, "average", True, True), (2, "zeros", False, False), (3, "average", False, True),
    (3, "zeros", True, False)])
def test_stride2_plain_versions_match_pallas(interpret, s, corner_mode, with_act, fold):
    c = _Case(40 + 10 * s + 2 * FOLDS.index((with_act, fold)) + MODES.index(corner_mode))
    h, w, cin, cout = 2**s, 2 ** (s + 1), 4, 5
    x, taps, bias = c.arr(2, 5, h, w, cin), c.arr(7, cin, cout, scale=0.3), c.arr(cout)
    act = c.act(cin) if with_act else None
    ref_y, ref_st = jck._pallas_forward(j(x), j(taps), j(bias), s, corner_mode, 2, j(act), True)
    y, st = ck.ico_conv_s2s_fwd(t(x), t(taps), t(bias), corner_mode, t(act), with_stats=True,
                                stride=2)
    assert tuple(y.shape) == (2, 5, h // 2, w // 2, cout)
    _close(y, ref_y)
    _close(st, ref_st)
    g = c.arr(2, 5, h // 2, w // 2, cout)
    gs = c.arr(2, cout, scale=0.1) if fold else None
    yf = np.asarray(ref_y) if fold else None
    xa = t(x) if with_act else None
    ref = jck._pallas_dx(j(g), j(taps), s, corner_mode, jnp.float32, 2, j(act),
                         j(x) if with_act else None, j(yf), j(gs), emit_gsum=True)
    got = ck.ico_conv_s2s_dx(t(g), t(taps), corner_mode, torch.float32, t(act), xa, t(yf), t(gs),
                             emit_gsum=True, stride=2)
    for a, b in zip(got, ref):
        _close(a, b)
    ref = jck._pallas_dtaps(j(x), j(g), s, corner_mode, 2, j(act), j(yf), j(gs))
    _close(ck.ico_conv_s2s_dtaps(t(x), t(g), corner_mode, t(act), t(yf), t(gs), stride=2), ref)
    ref = jck._std_bwd(j(x), j(g), j(taps), j(yf), j(gs), s, corner_mode, 2, j(act), fold,
                       jnp.float32)
    got = ck.ico_conv_s2s_bwd(t(x), t(g), t(taps), t(yf), t(gs), corner_mode, t(act), fold,
                              stride=2)
    for a, b in zip(got, ref):
        _close(a, b)


# ---------------------------------------------------------------------------
# the Function against the JAX op and jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s, corner_mode, route", [
    (2, "average", dict()), (2, "zeros", dict(merged_bwd=True)),
    (2, "average", dict(kernel_geff="0"))])
def test_fused_stride2_matches_the_jax_op_and_its_gradients(interpret, s, corner_mode, route):
    c = _Case(60 + s + 2 * MODES.index(corner_mode))
    cin, cout = 3, 4
    inputs = [c.arr(2, 5, 2**s, 2 ** (s + 1), cin), c.arr(7, cin, cout), c.arr(cout),
              *c.act(cin)]

    def jfn(x, taps, bias, mul, add):
        return jck.fused_ico_conv_s2s(x, taps, bias, s, corner_mode, 2, act=(mul, add),
                                      with_stats=True)

    def tfn(x, taps, bias, mul, add):
        return fused.fused_ico_conv_s2s(x, taps, bias, s, corner_mode, 2, act=(mul, add),
                                        with_stats=True, **route)

    outs = jax.tree.leaves(jfn(*j(inputs)))
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    touts = tfn(*tin)
    for a, b in zip(touts, outs, strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    r = np.random.RandomState(s)
    weights = [r.randn(*o.shape).astype(np.float32) for o in outs]

    def jloss(*a):
        return sum(jnp.sum(o * wt) for o, wt in zip(jax.tree.leaves(jfn(*a)), weights))

    ref = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*j(inputs))
    loss = sum((o * torch.from_numpy(wt)).sum() for o, wt in zip(touts, weights))
    for a, b in zip(torch.autograd.grad(loss, tin), ref, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------


def _phase_index(h, w):
    """Cell (chart, i, j) of a (5, h, w) grid -> its index p·5hw/4 + cell
    in the concatenated parity phases of ``phase_split``."""
    c, i, k = np.unravel_index(np.arange(5 * h * w), (5, h, w))
    ho, wo = h // 2, w // 2
    return (2 * (i & 1) + (k & 1)) * 5 * ho * wo + c * ho * wo + (i >> 1) * wo + (k >> 1)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3, 5])
def test_stride2_table_is_the_phase_tables_output_phase_2(s, corner_mode):
    h, w = 2**s, 2 ** (s + 1)
    std = halo.std_conv_table(h, w, corner_mode, stride=2)
    assert std.shape == (7, 5 * h * w // 4)
    relabel = _phase_index(h, w)
    mapped = np.where(std >= 0, relabel[np.maximum(std, 0)], std)
    np.testing.assert_array_equal(mapped, halo.phase_conv_table(h // 2, w // 2, corner_mode)[2])
    # a stride-2 centre never reads a pole, under either corner mode
    assert int(std.min()) >= halo.ZERO


def _dense(table, n_in, h, w):
    """The conv table as 7 dense (n_out, n_in) read matrices (poles 0.2 each)."""
    A = np.zeros((7, table.shape[1], n_in))
    for code, cells in ((halo.NORTH, [c * h * w for c in range(5)]),
                        (halo.SOUTH, [c * h * w + h * w - 1 for c in range(5)])):
        for tap, m in zip(*np.nonzero(table == code)):
            A[tap, m, cells] += 0.2
    tap, m = np.nonzero(table >= 0)
    np.add.at(A, (tap, m, table[tap, m]), 1.0)
    return A


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("stride, s", [(1, 2), (2, 2), (2, 3)])
def test_std_dx_table_is_the_adjoint(s, stride, corner_mode):
    h, w = 2**s, 2 ** (s + 1)
    n_in = 5 * h * w
    A = _dense(halo.std_conv_table(h, w, corner_mode, stride), n_in, h, w)
    offsets, cells, weights = halo.std_dx_table(h, w, corner_mode, stride)
    AT = np.zeros((7, n_in, A.shape[1]))
    for row in range(7 * n_in):
        for x in range(offsets[row], offsets[row + 1]):
            AT[row // n_in, row % n_in, cells[x]] += weights[x]
    np.testing.assert_allclose(AT, A.transpose(0, 2, 1), atol=1e-7)


# the stride-2 convs at the s=5 DownBlocks' inputs: (h, w) -> mask bytes
S2_FACTS = {(32, 64): 80, (16, 32): 20, (8, 16): 5}


@pytest.mark.parametrize("key", list(S2_FACTS))
def test_stride2_code_table_facts_at_s5(key):
    """No combined row (no pole, no cell read twice by one tap), every code
    one of the 5hw/4 cotangent rows or ZERO, each output cell read once a
    tap, and a mask byte per 128 of the 5hw input rows, every tap live in
    each: a tile's rows mix the four parities, so the dx GEMM steps through
    all 7 taps, 4x the forward's steps (the phase form's rows, one parity
    phase a tile, skip two thirds of them: test_torch_dx_rows.py)."""
    h, w = key
    M_in = 5 * h * w
    codes, (offsets, _, _), mask = halo.std_dx_codes(h, w, "average", stride=2)
    assert codes.shape == (1, 7, M_in) and len(offsets) == 1
    assert int(codes.min()) == halo.ZERO and int(codes.max()) == M_in // 4 - 1
    assert int((codes >= 0).sum()) == 7 * M_in // 4
    assert len(mask) == S2_FACTS[key] and bool((mask == 0x7F).all())


# ---------------------------------------------------------------------------
# the kernels' index arithmetic, replayed
# ---------------------------------------------------------------------------


def _operand_rows(operand, table, B, hw5):
    """Rows of the operand a conv table names: per sample hw5 input cells
    and 2 pole rows, then the zero row (``mma.cuh:OperandRows``)."""
    per_b = hw5 + 2
    b = torch.arange(B)[:, None, None]
    code = torch.from_numpy(table.astype(np.int64))[None]
    row = torch.where(code >= 0, b * per_b + code,
                      torch.where(code == halo.ZERO, B * per_b,
                                  b * per_b + per_b - 2 + (code == halo.SOUTH).long()))
    return operand.float()[row]  # (B, 7, M, C)


def _rows_fwd(x, taps, bias, corner_mode, act, stride):
    B, _, h, w, cin = x.shape
    operand = pk.grid_operand_plain([x], act, corner_mode)[:, :cin]
    A = _operand_rows(operand, halo.std_conv_table(h, w, corner_mode, stride), B, 5 * h * w)
    out = torch.einsum("btmk,tkn->bmn", A, taps.float()) + bias.float()
    return out.reshape(B, 5, h // stride, w // stride, -1).to(x.dtype)


def _rows_dx(g, taps, corner_mode, stride, h, w):
    """The dx GEMM: 5hw input rows a sample, each reading through the
    (1, 7, 5hw) code table the written cotangent's rows (5hw / stride²
    cotangent rows and the combined rows a sample, then a zero row)."""
    B, cout = g.shape[0], g.shape[-1]
    codes, comb, _ = halo.std_dx_codes(h, w, corner_mode, stride)
    rows = pk.cot_operand_plain([[g]], corner_mode=corner_mode, out_phases=None) \
        if stride == 1 else torch.cat([g.reshape(-1, cout), g.new_zeros((1, cout))])
    per = 5 * h * w // stride**2 + len(comb[0]) - 1
    code = torch.from_numpy(codes[0].astype(np.int64))[None]
    b = torch.arange(B)[:, None, None]
    row = torch.where(code >= 0, b * per + code, torch.full_like(code, B * per))
    d = torch.einsum("btmn,tkn->bmk", rows[:, :cout].float()[row], taps.float())
    return d.reshape(B, 5, h, w, -1).to(g.dtype)


def _rows_dtaps(x, g, corner_mode, act, stride):
    B, _, h, w, cin = x.shape
    operand = pk.grid_operand_plain([x], act, corner_mode)[:, :cin]
    A = _operand_rows(operand, halo.std_conv_table(h, w, corner_mode, stride), B, 5 * h * w)
    return torch.einsum("btmk,bmn->tkn", A, g.reshape(B, -1, g.shape[-1]).float()).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 3, 4), (2, 5, 8), (3, 12, 20), (4, 16, 9)])
def test_rows_replay_is_the_plain_stride2_conv(s, cin, cout, corner_mode, dtype):
    c = _Case(90 + 10 * s + cin)
    h, w = 2**s, 2 ** (s + 1)
    x = torch.from_numpy(c.arr(2, 5, h, w, cin)).to(dtype)
    taps = torch.from_numpy(c.arr(7, cin, cout, scale=0.3)).to(dtype)
    bias = torch.from_numpy(c.arr(cout)).to(dtype)
    act = tuple(map(torch.from_numpy, c.act(cin)))
    g = torch.from_numpy(c.arr(2, 5, h // 2, w // 2, cout)).to(dtype)
    for a in (act, None):
        _close(_rows_fwd(x, taps, bias, corner_mode, a, 2),
               ck.ico_conv_s2s_fwd_plain(x, taps, bias, corner_mode, a, stride=2), TOL[dtype])
        _close(_rows_dtaps(x, g, corner_mode, a, 2),
               ck.ico_conv_s2s_dtaps_plain(x, g, corner_mode, a, stride=2), TOL[dtype])
    _close(_rows_dx(g, taps, corner_mode, 2, h, w),
           ck.ico_conv_s2s_dx_plain(g, taps, corner_mode, dtype, stride=2)[0], TOL[dtype])

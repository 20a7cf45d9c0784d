"""The kernels of the default AE training step that the decoder-only route
(``pallas_blocks="up0,up1,up2"``) does not run, against the JAX package: the
standard conv's forward with stats, its dx and dtaps, and the fused head +
position loss.

* The plain versions (the wrappers' CPU route) against the Pallas kernels in
  interpret mode: ``_pallas_forward(with_stats=True)``, ``_pallas_dx`` with
  and without ``emit_gsum``, ``_pallas_dtaps`` (s=2 and 3, both corner
  modes, act and the stats fold on and off), and ``_phmse`` / ``_phmse_bwd``
  (through ``jax.vjp`` of ``fused_pair_head_mse``); float32, 1e-5·max|ref|
  (only the order of the float32 sums differs).
* ``fused_ico_conv_s2s`` and ``fused_pair_head_mse`` (``torch.autograd``
  Functions) against ``jax.grad`` of the JAX functions in interpret mode,
  through the outputs and the stats: 2e-4·max|ref|, as
  tests/test_kernel_fusion.py.
* ``halo.std_dx_table`` replayed on the CPU as the dx kernel uses it,
  against the plain adjoint: s=1..4, both corner modes, float32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.ops.pallas import conv_kernel as jck
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
from geniconet_tpu_torch.ops.kernels import fused, halo
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

MODES = ["average", "zeros"]
FOLDS = [(True, True), (True, False), (False, True)]  # (act, fold)


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
    ref = np.asarray(ref, np.float32)
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
# kernel f and the standard conv's stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_act, fold", FOLDS)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [2, 3])
def test_std_conv_stats_dx_and_dtaps_match_pallas(interpret, s, corner_mode, with_act, fold):
    c = _Case(10 * s + 2 * FOLDS.index((with_act, fold)) + MODES.index(corner_mode))
    h, w, cin, cout = 2**s, 2 ** (s + 1), 4, 5
    x, taps, bias = c.arr(2, 5, h, w, cin), c.arr(7, cin, cout, scale=0.3), c.arr(cout)
    act = c.act(cin) if with_act else None
    ref_y, ref_st = jck._pallas_forward(j(x), j(taps), j(bias), s, corner_mode, 1, j(act), True)
    y, st = ck.ico_conv_s2s_fwd(t(x), t(taps), t(bias), corner_mode, t(act), with_stats=True)
    _close(y, ref_y)
    _close(st, ref_st)
    g = c.arr(2, 5, h, w, cout)
    gs = c.arr(2, cout, scale=0.1) if fold else None
    yf = np.asarray(ref_y) if fold else None
    emit = fold or not with_act  # both with and without Σg across the cases
    ref = jck._pallas_dx(j(g), j(taps), s, corner_mode, jnp.float32, 1, j(act),
                         j(x) if with_act else None, j(yf), j(gs), emit_gsum=emit)
    got = ck.ico_conv_s2s_dx(t(g), t(taps), corner_mode, torch.float32, t(act),
                             t(x) if with_act else None, t(yf), t(gs), emit_gsum=emit)
    for a, b in zip(got, ref):
        _close(a, b)
    ref = jck._pallas_dtaps(j(x), j(g), s, corner_mode, 1, j(act), j(yf), j(gs))
    _close(ck.ico_conv_s2s_dtaps(t(x), t(g), corner_mode, t(act), t(yf), t(gs)), ref)


def test_std_conv_dtaps_round_to_the_activation_dtype():
    """The Pallas wrapper returns dtaps as x's dtype (conv_kernel.py:675):
    in bfloat16 the plain version's float32 sums are rounded once (with
    corner_mode 'zeros', where the halo holds no bf16 pole means, they are
    the float32 ones)."""
    c = _Case(3)
    x = torch.from_numpy(c.arr(2, 5, 4, 8, 4)).bfloat16()
    g = torch.from_numpy(c.arr(2, 5, 4, 8, 5)).bfloat16()
    got = ck.ico_conv_s2s_dtaps(x, g, "zeros")
    assert got.dtype == torch.bfloat16
    ref = ck.ico_conv_s2s_dtaps(x.float(), g.float(), "zeros")
    assert torch.equal(got, ref.bfloat16())


def _grads_match(jfn, tfn, inputs, seed, tol=2e-4):
    """jax.grad and torch autograd of sum(out · R) over every output, with
    the same random R."""
    r = np.random.RandomState(seed)
    outs = jax.tree.leaves(jfn(*j(inputs)))
    weights = [r.randn(*o.shape).astype(np.float32) for o in outs]

    def jloss(*a):
        return sum(jnp.sum(o * wt) for o, wt in zip(jax.tree.leaves(jfn(*a)), weights))

    ref = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*j(inputs))
    tin = [torch.from_numpy(np.array(a)).requires_grad_() for a in inputs]
    tout = tfn(*tin)
    tout = [tout] if isinstance(tout, torch.Tensor) else list(tout)
    assert len(tout) == len(outs)
    loss = sum((o * torch.from_numpy(wt)).sum() for o, wt in zip(tout, weights))
    for a, b in zip(torch.autograd.grad(loss, tin), ref):
        _close(a, b, tol)


@pytest.mark.parametrize("corner_mode", MODES)
def test_fused_ico_conv_s2s_grads_match_jax(interpret, corner_mode):
    c = _Case(21)
    s, cin, cout = 2, 4, 6
    inputs = [c.arr(2, 5, 2**s, 2 ** (s + 1), cin), c.arr(7, cin, cout, scale=0.3), c.arr(cout),
              *c.act(cin)]

    def jfn(x, taps, bias, mul, add):
        return jck.fused_ico_conv_s2s(x, taps, bias, s, corner_mode, act=(mul, add),
                                      with_stats=True)

    def tfn(x, taps, bias, mul, add):
        return fused.fused_ico_conv_s2s(x, taps, bias, s, corner_mode, act=(mul, add),
                                        with_stats=True)

    _grads_match(jfn, tfn, inputs, seed=5)


def test_fused_ico_conv_s2s_takes_stride_1_only():
    """Strides 1 and 2 run (stride 2 against JAX: tests/test_torch_std_s2.py);
    any other stride raises."""
    x = torch.zeros(1, 5, 4, 8, 3)
    assert fused.fused_ico_conv_s2s(x, torch.zeros(7, 3, 4), None, 2).shape == (1, 5, 4, 8, 4)
    assert fused.fused_ico_conv_s2s(x, torch.zeros(7, 3, 4), None, 2,
                                    stride=2).shape == (1, 5, 2, 4, 4)
    with pytest.raises(ValueError, match="stride"):
        fused.fused_ico_conv_s2s(x, torch.zeros(7, 3, 4), None, 2, stride=3)


# ---------------------------------------------------------------------------
# kernels g and h: the head + position loss
# ---------------------------------------------------------------------------


def _head_inputs(seed, s=2, C=6, F=3, B=2):
    c = _Case(seed)
    h, w = 2 ** (s - 1), 2**s
    phases = [c.arr(B, 5, h, w, C) for _ in range(8)]
    aff = [*c.act(C), *c.act(C)]
    W, bias = c.arr(C, F, scale=0.4), c.arr(F, scale=0.1)
    tpack, tpoles = c.arr(B, 5, h, w, 4 * F, scale=0.5), c.arr(B, 2 * F, scale=0.5)
    return phases[:4], phases[4:], aff, W, bias, tpack, tpoles


@pytest.mark.parametrize("s", [2, 3])
def test_pair_head_mse_matches_pallas(interpret, s):
    b0, y10, aff, W, bias, tpack, tpoles = _head_inputs(30 + s, s=s)
    args = (j(b0), j(y10), j(aff), j(W), j(bias), j(tpack), j(tpoles))
    sse, vjp = jax.vjp(lambda *a: jpk.fused_pair_head_mse(*a), *args)
    targs = (t(b0), t(y10), t(aff), t(W), t(bias), t(tpack), t(tpoles))
    _close(pk.pair_head_mse_fwd(*targs), sse)
    g = np.array([1.5, -0.5], np.float32)
    db0, dy10, daff, dW, dbias, dtp, dtpoles = vjp(jnp.asarray(g))
    got = pk.pair_head_mse_bwd(torch.from_numpy(g), *targs)
    for a, b in zip((*got[0], *got[1]), (*db0, *dy10)):
        _close(a, b)
    _close(got[2], dW)
    _close(got[3], dbias)
    for a, b in zip(got[4:], daff):
        _close(a, b)
    assert not np.any(np.asarray(dtp)) and not np.any(np.asarray(dtpoles))


@pytest.mark.parametrize("s", [2, 3])
def test_pair_head_mse_matches_pallas_in_bf16(interpret, s):
    """The same in bfloat16 (the phases, W and bias rounded to bf16 from the
    same float32 values on both sides), as the card holds the bf16 kernels g
    and h to these plain versions: the per-sample sse, the 8 phase
    cotangents (bf16), dW, dbias (in W's dtype) and the affine gradients
    within 2e-2·max|ref| (TOL[bf16] of the card tests), as z's float32 sums
    in two orders may round to bf16 one ulp apart."""
    tol = 2e-2
    b0, y10, aff, W, bias, tpack, tpoles = _head_inputs(50 + s, s=s, C=16)
    bf = jnp.bfloat16
    args = ([jnp.asarray(a).astype(bf) for a in b0], [jnp.asarray(a).astype(bf) for a in y10],
            j(aff), jnp.asarray(W).astype(bf), jnp.asarray(bias).astype(bf), j(tpack), j(tpoles))
    sse, vjp = jax.vjp(lambda *a: jpk.fused_pair_head_mse(*a), *args)
    targs = ([a.bfloat16() for a in t(b0)], [a.bfloat16() for a in t(y10)], t(aff),
             t(W).bfloat16(), t(bias).bfloat16(), t(tpack), t(tpoles))
    got = pk.pair_head_mse_fwd(*targs)
    assert got.dtype == torch.float32
    _close(got, sse, tol)
    g = np.array([1.5, -0.5], np.float32)
    db0, dy10, daff, dW, dbias, _, _ = vjp(jnp.asarray(g))
    got = pk.pair_head_mse_bwd(torch.from_numpy(g), *targs)
    for a, b in zip((*got[0], *got[1]), (*db0, *dy10)):
        assert a.dtype == torch.bfloat16
        _close(a, b, tol)
    _close(got[2], dW, tol)
    _close(got[3], dbias, tol)
    for a, b in zip(got[4:], daff):
        _close(a, b, tol)


def test_fused_pair_head_mse_grads_match_jax(interpret):
    b0, y10, aff, W, bias, tpack, tpoles = _head_inputs(40)
    inputs = [*b0, *y10, *aff, W, bias]

    def jfn(*a):
        return jpk.fused_pair_head_mse(a[0:4], a[4:8], a[8:12], a[12], a[13], j(tpack), j(tpoles))

    def tfn(*a):
        return fused.fused_pair_head_mse(a[0:4], a[4:8], a[8:12], a[12], a[13], t(tpack),
                                         t(tpoles))

    _grads_match(jfn, tfn, inputs, seed=6)


def test_pair_head_mse_plain_equals_head_then_position_sse():
    """The plain head+MSE is the plain head's outputs, interleaved, through
    the decoder's position SSE (poles included)."""
    from geniconet_tpu_torch.nn.models import _position_sse
    from geniconet_tpu_torch.ops.phase import phase_merge

    b0, y10, aff, W, bias, tpack, tpoles = t(_head_inputs(41, s=3))
    out = phase_merge(pk.pair_head_fwd(b0, y10, aff, W, bias))
    _close(pk.pair_head_mse_fwd(b0, y10, aff, W, bias, tpack, tpoles),
           _position_sse(out, tpack, tpoles).numpy())


# ---------------------------------------------------------------------------
# the standard conv's transposed table, replayed on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_std_dx_table_reproduces_the_plain_adjoint(s, corner_mode, dt):
    """What the dx kernel computes with the table: for each input cell r and
    tap t, the weighted sum of the g rows its CSR row lists, times W_t^T,
    summed in float32 and rounded once."""
    gen = torch.Generator().manual_seed(100 + s)
    h, w, B, cin, cout = 2**s, 2 ** (s + 1), 2, 3, 4
    M = 5 * h * w
    taps = (torch.randn(7, cin, cout, generator=gen) * 0.3).to(dt)
    g = torch.randn(B, 5, h, w, cout, generator=gen).to(dt)
    ref, *_ = ck.ico_conv_s2s_dx_plain(g, taps, corner_mode, dt)
    off, cells, wts = (torch.from_numpy(a) for a in halo.std_dx_table(h, w, corner_mode))
    contrib = torch.einsum("bqn,tkn->btqk", g.reshape(B, M, cout).float(), taps.float())
    rows = torch.repeat_interleave(torch.arange(7 * M), (off[1:] - off[:-1]).long())
    got = torch.zeros(B, M, cin)
    got.index_add_(1, rows % M, wts[None, :, None] * contrib[:, rows // M, cells.long()])
    _close(got.to(dt).reshape(ref.shape), ref.float(), 1e-5 if dt == torch.float32 else 2e-2)

"""The four serving kernels: plain versions against the JAX package, the
gather tables against the plain versions, and (on a card) the CUDA kernels.

* Each plain version (the wrapper's CPU route) is held against the JAX
  fused function it ports: under Pallas interpret mode at one tiny shape,
  and against the JAX XLA composition (``phase_conv``, ``ico_conv_s2s``,
  ``ico_upsample_s2s``) elsewhere. float32, tolerance 1e-5·max|ref| (only the
  order of the float32 sums differs).
* ``_emulate`` replays in PyTorch what the CUDA loaders do with the int32
  halo tables (codes, pole means, midpoint pairs and the dtype roundings),
  so the tables' meaning is checked on the CPU, in float32 and bfloat16.
* The CUDA kernels themselves are tested on the card in test_torch_cuda.py.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.geometry import ico
from geniconet_tpu.nn.layers import _xla_act
from geniconet_tpu.ops import conv as jconv
from geniconet_tpu.ops import phase as jphase
from geniconet_tpu.ops import upsample as jup
from geniconet_tpu.ops.pallas import conv_kernel as jck
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch.ops.kernels import build, halo
from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODES = ["average", "zeros"]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _close(got, ref, tol=1e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref.float() if isinstance(ref, torch.Tensor) else ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


class _Case:
    """Seeded numpy inputs for one kernel call, handed to JAX and to torch."""

    def __init__(self, seed):
        self.r = np.random.RandomState(seed)

    def randn(self, *shape, scale=1.0):
        return (scale * self.r.randn(*shape)).astype(np.float32)

    def act(self, c):
        return (self.r.uniform(0.5, 1.5, c).astype(np.float32), self.randn(c, scale=0.3))


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


# ---------------------------------------------------------------------------
# phase conv: fused_phase_conv_s1 / fused_dual_s2_conv
# ---------------------------------------------------------------------------


def _phase_inputs(s, cin, cout, seed, B=2):
    c = _Case(seed)
    h, w = ico.chart_shape(s - 1)
    phases = [c.randn(B, 5, h, w, cin) for _ in range(4)]
    return phases, [c.randn(7, cin, cout, scale=0.3) for _ in range(2)], c.act(cin)


def test_phase_conv_plain_matches_pallas_interpret(interpret):
    phases, (ta, tb), act = _phase_inputs(2, 4, 6, seed=0, B=1)
    ja, jb = jpk.fused_dual_s2_conv(_j(*phases), *_j(ta), None, *_j(tb), None, "average",
                                    act=tuple(_j(*act)))
    got = pk.phase_conv_fwd(_t(*phases), [(_t(ta)[0], None), (_t(tb)[0], None)], "average",
                            (2,), tuple(_t(*act)))
    _close(got[0][0], ja)
    _close(got[1][0], jb)
    jout = jpk.fused_phase_conv_s1(_j(*phases), *_j(ta), None, "average", act=tuple(_j(*act)))
    (out,) = pk.phase_conv_fwd(_t(*phases), [(_t(ta)[0], None)], "average",
                               act=tuple(_t(*act)))
    for a, b in zip(out, jout):
        _close(a, b)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [2, 3])
def test_phase_conv_plain_matches_xla(s, corner_mode):
    phases, (ta, tb), act = _phase_inputs(s, 5, 4, seed=s)
    jact = tuple(_j(*act))
    jph = tuple(_xla_act(p, jact) for p in _j(*phases))
    for out_phases in [(0, 1, 2, 3), (2,)]:
        got = pk.phase_conv_fwd(_t(*phases), [(_t(ta)[0], None), (_t(tb)[0], None)],
                                corner_mode, out_phases, tuple(_t(*act)))
        for taps, outs in zip((ta, tb), got):
            ref = jphase.phase_conv(jph, jnp.asarray(taps), None, corner_mode, out_phases)
            for a, b in zip(outs, ref):
                _close(a, b)


# ---------------------------------------------------------------------------
# upsample + dual conv: fused_up_dual_conv
# ---------------------------------------------------------------------------


def _up_inputs(s, cin, cout, seed, B=2):
    c = _Case(seed)
    h, w = ico.chart_shape(s)
    return c.randn(B, 5, h, w, cin), [c.randn(7, cin, cout, scale=0.3) for _ in range(2)]


def test_up_conv_plain_matches_pallas_interpret(interpret):
    x, (ta, tb) = _up_inputs(1, 4, 6, seed=3, B=1)
    ja, jb = jpk.fused_up_dual_conv(jnp.asarray(x), *_j(ta), None, *_j(tb), None, "average")
    ga, gb = pk.up_dual_conv_fwd(_t(x)[0], [(_t(ta)[0], None), (_t(tb)[0], None)])
    for got, ref in zip((*ga, *gb), (*ja, *jb)):
        _close(got, ref)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3])
def test_up_conv_plain_matches_xla(s, corner_mode):
    """upsample + conv == the grid conv of ico_upsample_s2s at level s+1."""
    x, (ta, tb) = _up_inputs(s, 4, 5, seed=10 + s)
    got = pk.up_dual_conv_fwd(_t(x)[0], [(_t(ta)[0], None), (_t(tb)[0], None)], corner_mode)
    up = jup.ico_upsample_s2s(jnp.asarray(x), s, corner_mode)
    for taps, outs in zip((ta, tb), got):
        ref = jconv.ico_conv_s2s(up, jnp.asarray(taps), None, s + 1, 1, corner_mode)
        _close(torch.stack(outs), jnp.stack(jphase.phase_split(ref)))


# ---------------------------------------------------------------------------
# pair head: fused_pair_head
# ---------------------------------------------------------------------------


def _head_inputs(seed, B=2, h=2, w=4, C=8, F=3):
    c = _Case(seed)
    b0 = [c.randn(B, 5, h, w, C) for _ in range(4)]
    y10 = [c.randn(B, 5, h, w, C) for _ in range(4)]
    aff = [*c.act(C), *c.act(C)]
    return b0, y10, aff, c.randn(C, F, scale=0.3), c.randn(F)


def test_pair_head_plain_matches_pallas_interpret(interpret):
    b0, y10, aff, W, bias = _head_inputs(4, B=1)
    ref = jpk.fused_pair_head(_j(*b0), _j(*y10), _j(*aff), jnp.asarray(W), jnp.asarray(bias))
    got = pk.pair_head_fwd(_t(*b0), _t(*y10), _t(*aff), *_t(W, bias))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _close(a, b)


@pytest.mark.parametrize("C", [8, 20])
def test_pair_head_plain_matches_pallas_interpret_in_bf16(interpret, C):
    """The same in bfloat16 (the phases, W and bias rounded to bf16 from the
    same float32 values on both sides; the affines stay float32), as the card
    holds the bf16 kernel to this plain version: within TOL[bf16] =
    2e-2·max|ref|, as z's float32 sums in two orders may round to bf16 one
    ulp apart before tanh."""
    b0, y10, aff, W, bias = _head_inputs(6, B=1, C=C)
    bf = jnp.bfloat16
    ref = jpk.fused_pair_head([a.astype(bf) for a in _j(*b0)], [a.astype(bf) for a in _j(*y10)],
                              _j(*aff), jnp.asarray(W).astype(bf), jnp.asarray(bias).astype(bf))
    got = pk.pair_head_fwd([a.bfloat16() for a in _t(*b0)], [a.bfloat16() for a in _t(*y10)],
                           _t(*aff), *[a.bfloat16() for a in _t(W, bias)])
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _close(a, b, TOL[torch.bfloat16])


def test_pair_head_mse_plain_matches_pallas_interpret_at_c320(interpret):
    """The head+MSE (g) and its backward (h) at a head wider than 256
    channels, C 320, where the card's backward walks a cell in rounds: the
    plain versions (the card's references) against the Pallas
    ``fused_pair_head_mse`` and ``jax.vjp`` of it in interpret mode, level
    2, B=1, float32: the sse, the 8 phase cotangents, dW, dbias and the
    affine gradients within 1e-5·max|ref| (only the order of the float32
    sums differs)."""
    import jax

    C, F = 320, 3
    c = _Case(9)
    b0, y10, aff, W, bias = _head_inputs(9, B=1, C=C, F=F)
    W = W * C**-0.5
    tpack, tpoles = c.randn(1, 5, 2, 4, 4 * F, scale=0.5), c.randn(1, 2 * F, scale=0.5)
    args = (_j(*b0), _j(*y10), _j(*aff), jnp.asarray(W), jnp.asarray(bias), jnp.asarray(tpack),
            jnp.asarray(tpoles))
    sse, vjp = jax.vjp(lambda *a: jpk.fused_pair_head_mse(*a), *args)
    targs = (_t(*b0), _t(*y10), _t(*aff), *_t(W, bias, tpack, tpoles))
    _close(pk.pair_head_mse_fwd(*targs), sse)
    g = np.array([1.5], np.float32)
    db0, dy10, daff, dW, dbias, _, _ = vjp(jnp.asarray(g))
    got = pk.pair_head_mse_bwd(torch.from_numpy(g), *targs)
    for u, v in zip((*got[0], *got[1]), (*db0, *dy10)):
        _close(u, v)
    _close(got[2], dW)
    _close(got[3], dbias)
    for u, v in zip(got[4:], daff):
        _close(u, v)


def test_pair_head_plain_matches_xla():
    b0, y10, aff, W, bias = _head_inputs(5)
    m1, a1, m2, a2 = _j(*aff)
    got = pk.pair_head_fwd(_t(*b0), _t(*y10), _t(*aff), *_t(W, bias))
    for g, a, b in zip(got, _j(*b0), _j(*y10)):
        t = jnp.maximum(a * m1 + a1 + b * m2 + a2, 0.0)
        _close(g, jnp.tanh(t @ jnp.asarray(W) + jnp.asarray(bias)))


# ---------------------------------------------------------------------------
# standard conv: fused_ico_conv_s2s
# ---------------------------------------------------------------------------


def _std_inputs(s, C, seed, B=2):
    c = _Case(seed)
    h, w = ico.chart_shape(s)
    return c.randn(B, 5, h, w, C), c.randn(7, C, C, scale=0.3), c.act(C)


def test_std_conv_plain_matches_pallas_interpret(interpret):
    x, taps, act = _std_inputs(2, 4, seed=6, B=1)
    ref = jck.fused_ico_conv_s2s(jnp.asarray(x), jnp.asarray(taps), None, 2, "average",
                                 act=tuple(_j(*act)))
    _close(ck.ico_conv_s2s_fwd(*_t(x, taps), None, "average", tuple(_t(*act))), ref)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3])
def test_std_conv_plain_matches_xla(s, corner_mode):
    x, taps, act = _std_inputs(s, 6, seed=20 + s)
    ref = jconv.ico_conv_s2s(_xla_act(jnp.asarray(x), tuple(_j(*act))), jnp.asarray(taps),
                             None, s, 1, corner_mode)
    _close(ck.ico_conv_s2s_fwd(*_t(x, taps), None, corner_mode, tuple(_t(*act))), ref)


# ---------------------------------------------------------------------------
# the CUDA loaders' table semantics, replayed on the CPU
# ---------------------------------------------------------------------------


def _round(v, dt):
    return v.to(dt).float()


def _resolve(vals, codes, pole_n, pole_s):
    """vals (B, S, C) source cells; codes int array -> (B, len, C) float."""
    c = torch.as_tensor(np.asarray(codes), dtype=torch.long)
    out = vals[:, c.clamp(min=0)].clone()
    out[:, c == halo.ZERO] = 0
    out[:, c == halo.NORTH] = pole_n[:, None]
    out[:, c == halo.SOUTH] = pole_s[:, None]
    return out


def _poles(vals, hw, south_base, dt):
    """5-chart means of cell 0 and of cell south_base + hw - 1: fp32 sum x 0.2, cast."""
    n = _round(sum(vals[:, c * hw] for c in range(5)) * 0.2, dt)
    s = _round(sum(vals[:, south_base + c * hw + hw - 1] for c in range(5)) * 0.2, dt)
    return n, s


def _emulate_gemm(values, table, tap_sets, dt):
    """table (7, M) codes resolved by `values` -> per set (B, M, C_out) in dt."""
    outs = []
    for taps, bias in tap_sets:
        acc = sum(values(table[t]) @ taps[t].float() for t in range(7))
        outs.append((acc + (0 if bias is None else bias.float())).to(dt))
    return outs


def _emulate_grid(srcs, table, tap_sets, act, south_src, dt):
    B, _, h, w, C = srcs[0].shape
    hw = h * w
    vals = torch.cat([s.reshape(B, 5 * hw, C) for s in srcs], 1).float()
    if act is not None:
        vals = _round(torch.clamp_min(vals * act[0] + act[1], 0), dt)
    pn, ps = _poles(vals, hw, south_src * 5 * hw, dt)
    return _emulate_gemm(lambda c: _resolve(vals, c, pn, ps), table, tap_sets, dt)


def _emulate_up(x, conv_table_p, up_table, tap_sets, dt):
    B, _, h, w, C = x.shape
    hw = h * w
    xv = x.reshape(B, 5 * hw, C).float()
    pn, ps = _poles(xv, hw, 0, dt)
    a = _resolve(xv, up_table[:, 0], pn, ps)
    second = up_table[:, 1]
    b = _resolve(xv, np.where(second == halo.NONE, 0, second), pn, ps)
    mid = _round(_round(a + b, dt) * 0.5, dt)
    cells = torch.where(torch.as_tensor(second == halo.NONE)[None, :, None], a, mid)
    un, us = _poles(cells, hw, 3 * 5 * hw, dt)
    return _emulate_gemm(lambda c: _resolve(cells, c, un, us), conv_table_p, tap_sets, dt)


def _torch_sets(dt, seed, cin, cout, n_sets=2):
    g = torch.Generator().manual_seed(seed)
    return [((torch.randn(7, cin, cout, generator=g) * 0.3).to(dt),
             torch.randn(cout, generator=g).to(dt)) for _ in range(n_sets)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3])
def test_table_gathers_reproduce_plain_versions(s, corner_mode, dt):
    g = torch.Generator().manual_seed(s)
    H, W = ico.chart_shape(s)
    x = torch.randn(2, 5, H, W, 6, generator=g).to(dt)
    act = (torch.rand(6, generator=g) + 0.5, torch.randn(6, generator=g) * 0.3)
    sets = _torch_sets(dt, s, 6, 5)
    tol = TOL[dt]

    phases = tuple(x[:, :, p >> 1 :: 2, p & 1 :: 2].contiguous() for p in range(4))
    ref = pk.phase_conv_fwd_plain(phases, sets, corner_mode, (0, 1, 2, 3), act)
    table = halo.phase_conv_table(H // 2, W // 2, corner_mode)
    for p in range(4):
        got = _emulate_grid(phases, table[p], sets, act, 3, dt)
        for k in range(2):
            _close(got[k].reshape(ref[k][p].shape), ref[k][p], tol)

    ref = ck.ico_conv_s2s_fwd_plain(x, *sets[0], corner_mode, act)
    got = _emulate_grid([x], halo.std_conv_table(H, W, corner_mode), sets[:1], act, 0, dt)
    _close(got[0].reshape(ref.shape), ref, tol)

    ref = pk.up_dual_conv_fwd_plain(x, sets, corner_mode)
    table, up = halo.phase_conv_table(H, W, corner_mode), halo.upsample_table(H, W, corner_mode)
    for p in range(4):
        got = _emulate_up(x, table[p], up, sets, dt)
        for k in range(2):
            _close(got[k].reshape(ref[k][p].shape), ref[k][p], tol)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    build.reset_launches()
    phases, (ta, _), act = _phase_inputs(2, 3, 4, seed=7)
    pk.phase_conv_fwd(_t(*phases), [(_t(ta)[0], None)], act=tuple(_t(*act)))
    assert sum(build.LAUNCHES.values()) == 0


def test_wrappers_reject_other_out_phases():
    phases, (ta, _), _ = _phase_inputs(2, 3, 4, seed=8)
    with pytest.raises(ValueError):
        pk.phase_conv_fwd(_t(*phases), [(_t(ta)[0], None)], out_phases=(0, 1))


def test_head_constants_mirror_the_source():
    """``build``'s sizes of the pair head's scratch say what
    ``csrc/pair_head.cu`` launches: the MSE forward's partials (one a
    HEAD_MSE_CELLS cells of a sample) and the backward's grid."""
    import re

    src = (build.CSRC / "pair_head.cu").read_text()
    for name in ("HEAD_MSE_CELLS", "HEAD_BWD_BLOCKS", "HEAD_CELLS_A_BLOCK"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == getattr(
            build, name)
    assert build.head_mse_parts(36, 16, 32) == 36 * 40
    assert build.head_mse_parts(1, 2, 4) == 1
    assert build.head_bwd_blocks(36, 16, 32) == build.HEAD_BWD_BLOCKS


def test_block_constants_mirror_the_source():
    """``build``'s sizes of the merged blocks' SM-order counters say what
    ``csrc/mma_block_fwd.cuh`` indexes."""
    import re

    src = (build.CSRC / "mma_block_fwd.cuh").read_text()
    for name in ("MAX_SLOTS", "MAX_SM_IDS"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == getattr(
            build, name)


def test_kernels_build_inside_the_checkout():
    repo = Path(__file__).resolve().parents[1]
    assert build.BUILD_DIR == repo / "build" / "kernels"

"""The training kernels' plain versions and the port's custom VJPs against
the JAX package.

* The backward plain versions (the CPU route of ``phase_conv_dx``,
  ``phase_conv_dtaps``, ``up_dual_conv_dx``, ``up_dual_conv_dtaps``) and the
  ``with_stats`` forwards against the Pallas kernels in interpret mode, with
  the stats fold on and off, both output-phase modes; float32, 1e-5·max|ref|
  (only the order of the float32 sums differs).
* The three ``torch.autograd.Function``s against ``jax.grad`` of the JAX
  fused functions in interpret mode, through the outputs and the stats;
  2e-4·max|ref|, as tests/test_kernel_fusion.py; and ``needs_dx=False``,
  which gives the taps and bias their gradients and the input none.
* The transposed halo tables replayed on the CPU (what the dx kernels do
  with them) against the plain adjoint, s=1..4, both corner modes, float32
  and bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch.ops.kernels import fused, halo
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

MODES = ["average", "zeros"]


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _close(got, ref, tol=1e-5):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _close_tree(got, ref, tol=1e-5):
    if ref is None:
        assert got is None
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _close_tree(a, b, tol)
    else:
        _close(got, ref, tol)


class _Case:
    """Seeded numpy inputs, handed to JAX (``j``) and to torch (``t``)."""

    def __init__(self, seed, B=1, h=2, cin=3, cout=4):
        self.r = np.random.RandomState(seed)
        self.B, self.h, self.w, self.cin, self.cout = B, h, 2 * h, cin, cout

    def arr(self, *shape, scale=1.0):
        return (scale * self.r.randn(*shape)).astype(np.float32)

    def grid(self, c):
        return self.arr(self.B, 5, self.h, self.w, c)

    def act(self):
        return (self.r.uniform(0.5, 1.5, self.cin).astype(np.float32),
                self.arr(self.cin, scale=0.3))


def j(tree):
    return jax.tree.map(jnp.asarray, tree)


def t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


FOLDS = [(True, True), (True, False), (False, True)]  # (act, fold)


@pytest.mark.parametrize("out_phases", [(0, 1, 2, 3), (2,)])
@pytest.mark.parametrize("with_act, fold", FOLDS)
def test_phase_conv_dx_and_dtaps_match_pallas(interpret, out_phases, with_act, fold):
    c = _Case(7)
    n_sets = 2 if out_phases == (2,) else 1
    n = len(out_phases)
    phases = [c.grid(c.cin) for _ in range(4)]
    taps = [c.arr(7, c.cin, c.cout, scale=0.3) for _ in range(n_sets)]
    g = [[c.grid(c.cout) for _ in range(n)] for _ in range(n_sets)]
    y = [[c.grid(c.cout) for _ in range(n)] for _ in range(n_sets)] if fold else None
    gs = [c.arr(2, c.cout, scale=0.1) for _ in range(n_sets)] if fold else None
    act = c.act() if with_act else None
    raw = phases if with_act else None
    ref = jpk._phase_conv_dx(j(g), [(jnp.asarray(w), None) for w in taps], "average",
                             out_phases, c.cin, np.dtype("float32"), j(act), j(raw), j(y), j(gs))
    got = pk.phase_conv_dx(t(g), [(w, None) for w in t(taps)], "average", out_phases, c.cin,
                           torch.float32, t(act), t(raw), t(y), t(gs))
    _close_tree(got, ref)
    shapes = [w.shape for w in taps]
    ref = jpk._phase_conv_dtaps(j(phases), j(g), shapes, "average", out_phases, j(act), j(y),
                                j(gs), emit_gsum=True)
    got = pk.phase_conv_dtaps(t(phases), t(g), shapes, "average", out_phases, t(act), t(y),
                              t(gs), emit_gsum=True)
    _close_tree(got, ref)


def test_forward_stats_match_pallas(interpret):
    c = _Case(8)
    phases = [c.grid(c.cin) for _ in range(4)]
    sets = [(c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout)) for _ in range(2)]
    act = c.act()
    for out_phases, n in [((0, 1, 2, 3), 1), ((2,), 2)]:
        ref = jpk._phase_conv_fwd(j(phases), j(sets[:n]), "average", out_phases, j(act), True)
        got = pk.phase_conv_fwd(t(phases), t(sets[:n]), "average", out_phases, t(act), True)
        _close_tree(got, ref)
    x = c.grid(c.cin)
    ref = jpk._up_conv_fwd_impl(jnp.asarray(x), j(sets), "average", with_stats=True)
    _close_tree(pk.up_dual_conv_fwd(t(x), t(sets), with_stats=True), ref)


@pytest.mark.parametrize("fold", [True, False])
def test_up_conv_backward_matches_pallas_vjp(interpret, fold):
    """The up conv's two backward plain versions against ``jax.vjp`` of
    ``fused_up_dual_conv(with_stats=True)`` (its dx and dtaps kernels)."""
    c = _Case(9)
    x = c.grid(c.cin)
    ta, ba, tb, bb = (c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout),
                      c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout))
    g = [[c.grid(c.cout) for _ in range(4)] for _ in range(2)]
    gs = [c.arr(2, c.cout, scale=0.1) if fold else np.zeros((2, c.cout), np.float32)
          for _ in range(2)]
    (ya, yb, sa, sb), vjp = jax.vjp(
        lambda *a: jpk.fused_up_dual_conv(*a, "average", with_stats=True), *j((x, ta, ba, tb, bb)))
    dx, dta, dba, dtb, dbb = vjp((*j((tuple(g[0]), tuple(g[1]))), *j(gs)))
    fk = dict(y_groups=[[torch.from_numpy(np.array(v)) for v in ys] for ys in (ya, yb)],
              gs_list=t(gs)) if fold else {}
    got_dx, gsums = pk.up_dual_conv_dx(t(g), [(w, None) for w in t((ta, tb))], "average",
                                       torch.float32, emit_gsum=True, **fk)
    _close(got_dx, dx)
    _close_tree(gsums, [dba, dbb])
    _close_tree(pk.up_dual_conv_dtaps(t(x), t(g), "average", **fk), [dta, dtb])


# ---------------------------------------------------------------------------
# the autograd Functions against jax.grad of the JAX custom VJPs
# ---------------------------------------------------------------------------


def _grads_match(jfn, tfn, inputs, n_out_arrays, seed):
    """jax.grad and torch autograd of sum(out · R) over every output (the
    phases and the stats), with the same random R."""
    r = np.random.RandomState(seed)
    jin = j(inputs)

    def jloss(*a):
        outs = jax.tree.leaves(jfn(*a))
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    outs = jax.tree.leaves(jfn(*jin))
    assert len(outs) == n_out_arrays
    weights = [jnp.asarray(r.randn(*o.shape).astype(np.float32)) for o in outs]
    ref = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*jin)
    tin = [torch.from_numpy(np.array(a)).requires_grad_() for a in inputs]
    touts = [o for o in _flat(tfn(*tin))]
    loss = sum((o * torch.from_numpy(np.array(w))).sum() for o, w in zip(touts, weights))
    got = torch.autograd.grad(loss, tin)
    for a, b in zip(got, ref):
        _close(a, b, 2e-4)


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _flat(o)]


def test_fused_phase_conv_s1_grads_match_jax(interpret):
    c = _Case(11)
    inputs = [*(c.grid(c.cin) for _ in range(4)), c.arr(7, c.cin, c.cout, scale=0.3),
              c.arr(c.cout), *c.act()]

    def jfn(p0, p1, p2, p3, w, b, mul, add):
        return jpk.fused_phase_conv_s1((p0, p1, p2, p3), w, b, "average", act=(mul, add),
                                       with_stats=True, fold_ok=True, fold_site="up2")

    def tfn(p0, p1, p2, p3, w, b, mul, add):
        return fused.fused_phase_conv_s1((p0, p1, p2, p3), w, b, "average", act=(mul, add),
                                         with_stats=True)

    _grads_match(jfn, tfn, inputs, 5, seed=1)


def test_fused_phase_conv_s1_without_dx_matches_jax(interpret):
    """needs_dx=False (a data input): the taps and bias gradients as JAX's,
    and no input cotangent at all."""
    c = _Case(14)
    phases = [c.grid(c.cin) for _ in range(4)]

    def jfn(w, b):
        return jpk.fused_phase_conv_s1(tuple(j(phases)), w, b, "zeros", with_stats=True,
                                       needs_dx=False)

    def tfn(w, b):
        return fused.fused_phase_conv_s1(tuple(t(phases)), w, b, "zeros", with_stats=True,
                                         needs_dx=False)

    _grads_match(jfn, tfn, [c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout)], 5, seed=4)
    tp = [p.requires_grad_() for p in t(phases)]
    out, st = fused.fused_phase_conv_s1(tuple(tp), *t([c.arr(7, c.cin, c.cout), c.arr(c.cout)]),
                                        "zeros", with_stats=True, needs_dx=False)
    (sum(o.sum() for o in out) + st.sum()).backward()
    assert all(p.grad is None for p in tp)


def test_fused_dual_s2_conv_grads_match_jax(interpret):
    c = _Case(12)
    inputs = [*(c.grid(c.cin) for _ in range(4)), c.arr(7, c.cin, c.cout, scale=0.3),
              c.arr(c.cout), c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout), *c.act()]

    def jfn(p0, p1, p2, p3, ta, ba, tb, bb, mul, add):
        return jpk.fused_dual_s2_conv((p0, p1, p2, p3), ta, ba, tb, bb, "zeros",
                                      act=(mul, add), with_stats=True)

    def tfn(p0, p1, p2, p3, ta, ba, tb, bb, mul, add):
        return fused.fused_dual_s2_conv((p0, p1, p2, p3), ta, ba, tb, bb, "zeros",
                                        act=(mul, add), with_stats=True)

    _grads_match(jfn, tfn, inputs, 4, seed=2)


def test_fused_up_dual_conv_grads_match_jax(interpret):
    c = _Case(13)
    inputs = [c.grid(c.cin), c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout),
              c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout)]

    def jfn(*a):
        return jpk.fused_up_dual_conv(*a, "average", with_stats=True)

    def tfn(*a):
        return fused.fused_up_dual_conv(*a, "average", with_stats=True)

    _grads_match(jfn, tfn, inputs, 10, seed=3)


# ---------------------------------------------------------------------------
# the transposed tables, replayed on the CPU
# ---------------------------------------------------------------------------


def _replay_dx(g_cat, taps_cat, table, R):
    """What the dx kernels compute: for each source r and tap t, the
    weighted sum of the g rows its CSR row lists, times the tap's W^T; one
    rounding to g's dtype at the end."""
    off, cells, wts = (torch.from_numpy(a) for a in table)
    contrib = torch.einsum("bqn,tkn->btqk", g_cat.float(), taps_cat.float())
    rows = torch.repeat_interleave(torch.arange(7 * R), (off[1:] - off[:-1]).long())
    dx = torch.zeros(g_cat.shape[0], R, taps_cat.shape[1])
    dx.index_add_(1, rows % R, wts[None, :, None] * contrib[:, rows // R, cells.long()])
    return dx.to(g_cat.dtype)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_transposed_tables_reproduce_plain_adjoints(s, corner_mode, dt):
    gen = torch.Generator().manual_seed(s)
    h, w, B, cin, cout = 2**s, 2 ** (s + 1), 2, 3, 4
    taps = [(torch.randn(7, cin, cout, generator=gen) * 0.3).to(dt) for _ in range(2)]
    sets = [(tp, None) for tp in taps]
    tol = 1e-5 if dt == torch.float32 else 2e-2

    def cat(groups):
        return torch.cat([torch.cat([x.reshape(B, -1, cout) for x in grp], 1) for grp in groups], 2)

    for out_phases in [(0, 1, 2, 3), (2,)]:
        g = [[torch.randn(B, 5, h, w, cout, generator=gen).to(dt) for _ in out_phases]
             for _ in range(2)]
        ref, *_ = pk.phase_conv_dx_plain(g, sets, corner_mode, out_phases, cin, dt)
        got = _replay_dx(cat(g), torch.cat(taps, 2),
                         halo.phase_dx_table(h, w, corner_mode, out_phases), 4 * 5 * h * w)
        _close(got, torch.cat([x.reshape(B, -1, cin) for x in ref], 1).float(), tol)
    g = [[torch.randn(B, 5, h, w, cout, generator=gen).to(dt) for _ in range(4)]
         for _ in range(2)]
    ref, _ = pk.up_dual_conv_dx_plain(g, sets, corner_mode, dt)
    got = _replay_dx(cat(g), torch.cat(taps, 2), halo.up_dx_table(h, w, corner_mode), 5 * h * w)
    _close(got, ref.reshape(B, -1, cin).float(), tol)

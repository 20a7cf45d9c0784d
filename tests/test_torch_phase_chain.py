"""The encoder's phase chain (kernel m, ``phase_chain="enc"``) and the stats
fold outside the kernels (kernel l, ``kernel_geff``) against the JAX
package's own chain and fold routes, on the CPU.

The JAX side reads ``GENICONET_EXPERIMENTAL``, ``GENICONET_PHASE_CHAIN``,
``GENICONET_KERNEL_GEFF`` and ``GENICONET_PALLAS_FOLD`` when it traces, so
each test sets them (``monkeypatch``) before it calls into JAX. Pallas runs
in interpret mode. Inputs come from numpy seeds; tolerances, against each
output's max|ref|:

* (a) ``ds2s_fwd_plain``, ``ds2s_dx_plain`` and ``ds2s_dtaps_plain``
  against ``_ds2s`` and ``jax.vjp`` of ``fused_dual_s2_conv_split`` (its
  ``_ds2s_bwd``), with and without the act prologue and the in-kernel fold:
  1e-5 in float32 (only the order of the float32 sums differs);
* (b) ``geff_plain`` against ``_stats_geff`` under ``GENICONET_PALLAS_FOLD=1``
  (the Pallas kernel l): equal in float32 (the same float32 operations),
  within 1 bf16 ulp in bfloat16 (a last-bit difference in float32 may round
  either way);
* (c) ``fused_dual_s2_conv_split`` and the fused Functions under each
  ``kernel_geff`` value against ``jax.grad`` under the same
  ``GENICONET_KERNEL_GEFF``: 2e-4, as ``tests/test_torch_backward.py``; each
  side folds outside its kernels at the same calls;
* (d) the ``Trainer`` on the chain: ``tests/test_torch_phase_chain_train.py``;
* (e) the chained eval encode of both models against the JAX eval encode:
  1e-5;
* (f) ``phase_chain_enabled`` and ``kernel_geff_enabled`` parse as the JAX
  functions do; ``"dec"``/``"1"`` build, load the unchained state dict and
  run (the decoder's chain itself: ``tests/test_torch_dec_chain.py``), and
  an unknown value raises.

About 80 s in one process.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import geniconet_tpu.nn.models as jax_models
from geniconet_tpu.ops.pallas import conv_kernel as jck
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.nn.layers import kernel_geff_enabled, phase_chain_enabled
from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
from geniconet_tpu_torch.ops.kernels import fused
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk


@pytest.fixture
def env(monkeypatch):
    """Set the JAX package's experimental routing variables (read at trace
    time); a value of None unsets the variable."""
    def setenv(**values):
        monkeypatch.setenv("GENICONET_EXPERIMENTAL", "1")
        for name, value in values.items():
            if value is None:
                monkeypatch.delenv(f"GENICONET_{name}", raising=False)
            else:
                monkeypatch.setenv(f"GENICONET_{name}", value)
    return setenv


@pytest.fixture
def interpret():
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

    def __init__(self, seed, B=2, h=2, cin=3, cout=4):
        self.r = np.random.RandomState(seed)
        self.B, self.h, self.w, self.cin, self.cout = B, h, 2 * h, cin, cout

    def arr(self, *shape, scale=1.0):
        return (scale * self.r.randn(*shape)).astype(np.float32)

    def grid(self, c, h=None):
        h = self.h if h is None else h
        return self.arr(self.B, 5, h, 2 * h, c)

    def act(self):
        return (self.r.uniform(0.5, 1.5, self.cin).astype(np.float32),
                self.arr(self.cin, scale=0.3))


def j(tree):
    return jax.tree.map(jnp.asarray, tree)


def t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# (a) the plain versions of kernel m
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_act, fold, corner_mode", [(True, True, "average"),
                                                         (True, False, "zeros"),
                                                         (False, True, "zeros"),
                                                         (False, False, "average")])
def test_ds2s_plain_matches_pallas(env, interpret, with_act, fold, corner_mode):
    """The forward (8 phases and the stats) against ``_ds2s``; dx, d_mul,
    d_add, both dtaps and the bias gradients against ``jax.vjp`` of
    ``fused_dual_s2_conv_split``, whose backward folds in-kernel under
    ``GENICONET_KERNEL_GEFF=ds2`` (with stats) and has nothing to fold
    without stats."""
    env(KERNEL_GEFF="ds2")
    c = _Case(30 + 2 * with_act + fold, h=4)
    phases = [c.grid(c.cin) for _ in range(4)]
    ta, ba, tb, bb = (c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout),
                      c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout))
    act = c.act() if with_act else None
    mul, add = j(act) if with_act else (None, None)
    ref = jpk._ds2s(j(tuple(phases)), *j((ta, ba, tb, bb)), mul, add, corner_mode, True, True)
    sets = [(w, b) for w, b in zip(t((ta, tb)), t((ba, bb)))]
    got_sets, got_stats = pk.ds2s_fwd_plain(t(phases), sets, corner_mode, t(act), True)
    _close_tree([*got_sets, *got_stats], list(ref))

    def jfn(ph, ta, ba, tb, bb, *a):
        return jpk.fused_dual_s2_conv_split(ph, ta, ba, tb, bb, corner_mode,
                                            act=tuple(a) if a else None, with_stats=fold)

    outs, vjp = jax.vjp(jfn, j(tuple(phases)), *j((ta, ba, tb, bb)), *(j(act) if act else ()))
    g = [[c.grid(c.cout, h=2) for _ in range(4)] for _ in range(2)]
    gs = [c.arr(2, c.cout, scale=0.1) for _ in range(2)]
    cts = (*j((tuple(g[0]), tuple(g[1]))), *(j(gs) if fold else ()))
    dphases, dta, dba, dtb, dbb, *dact = vjp(cts)
    fk = dict(y_groups=[t(list(outs[0])), t(list(outs[1]))], gs_list=t(gs)) if fold else {}
    dx = pk.ds2s_dx_plain(t(g), sets, corner_mode, c.cin, torch.float32, t(act), t(phases), **fk)
    _close_tree(dx[:3], [dphases, *(dact or (None, None))])
    dtaps, gsums = pk.ds2s_dtaps_plain(t(phases), t(g), [(7, c.cin, c.cout)] * 2, corner_mode,
                                       t(act), emit_gsum=True, **fk)
    _close_tree([*dtaps, *gsums], [dta, dtb, dba, dbb])
    if fold:  # with the fold, the dx kernel emits the bias gradients
        _close_tree(dx[3], [dba, dbb])


# ---------------------------------------------------------------------------
# (b) the plain version of kernel l
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, n", [("float32", 4), ("bfloat16", 4), ("float32", 1)])
def test_geff_plain_matches_pallas_stats_geff(env, interpret, dtype, n):
    env(PALLAS_FOLD="1")
    c = _Case(40 + n, B=3, cout=8)
    g = [c.grid(c.cout) for _ in range(n)]
    y = [c.grid(c.cout) for _ in range(n)]
    gs = c.arr(2, c.cout, scale=0.5)
    jdt = jnp.dtype(dtype)
    with mock.patch.object(jpk, "_fold_geff_kernel", wraps=jpk._fold_geff_kernel) as spy:
        ref = jpk._stats_geff(tuple(jnp.asarray(a, jdt) for a in g),
                              tuple(jnp.asarray(a, jdt) for a in y), jnp.asarray(gs))
    assert spy.called
    tdt = getattr(torch, dtype)
    got = pk.geff_plain([torch.from_numpy(a).to(tdt) for a in g],
                        [torch.from_numpy(a).to(tdt) for a in y], torch.from_numpy(gs))
    for u, v in zip(got, ref):
        assert u.dtype == tdt
        u, v = u.float().numpy(), np.asarray(v.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_array_equal(u, v)
        else:  # one bf16 ulp: 2^(e-7) for |v| in [2^e, 2^(e+1))
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)
            assert (np.abs(u - v) <= ulp).all()


# ---------------------------------------------------------------------------
# (c) the Functions under each kernel_geff value against jax.grad
# ---------------------------------------------------------------------------


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _flat(o)]


def _grads_match(jfn, tfn, inputs, n_out_arrays, seed):
    """jax.grad and torch autograd of sum(out · R) over every output (the
    phases and the stats), with the same random R. Returns whether the JAX
    side ran the Pallas fold kernel l, and the port side ``stats_geff``."""
    r = np.random.RandomState(seed)
    jin = j(inputs)
    outs = jax.tree.leaves(jfn(*jin))
    assert len(outs) == n_out_arrays
    weights = [jnp.asarray(r.randn(*o.shape).astype(np.float32)) for o in outs]

    def jloss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jax.tree.leaves(jfn(*a)), weights))

    with mock.patch.object(jpk, "_fold_geff_kernel", wraps=jpk._fold_geff_kernel) as jspy:
        ref = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*jin)
    tin = [torch.from_numpy(np.array(a)).requires_grad_() for a in inputs]
    with mock.patch.object(fused, "stats_geff", wraps=fused.stats_geff) as tspy:
        loss = sum((o * torch.from_numpy(np.array(w))).sum()
                   for o, w in zip(_flat(tfn(*tin)), weights))
        got = torch.autograd.grad(loss, tin)
    for a, b in zip(got, ref):
        _close(a, b, 2e-4)
    return jspy.called, tspy.call_count


# (kernel_geff, fold_ok): JAX's built-in set (upd folds in-kernel, the
# others outside); every family, but in a restricted model without "!" (only
# std, which has no fold_ok, folds in-kernel); a list with "!" in one
# (pcs1_down1 and ds2 fold in-kernel). Each Function meets both placements.
_GEFF = [("", True), ("all", False), ("!pcs1_down1,ds2", False)]


def _functions(c):
    """(name, family, jfn, tfn, inputs, n_out_arrays, port stats_geff calls
    when the family folds outside) of the five Functions."""
    phases = [c.grid(c.cin) for _ in range(4)]
    w2 = [c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout), c.arr(7, c.cin, c.cout, scale=0.3),
          c.arr(c.cout)]
    act = list(c.act())

    def ds2(split):
        jf, tf = ((jpk.fused_dual_s2_conv_split, fused.fused_dual_s2_conv_split) if split
                  else (jpk.fused_dual_s2_conv, fused.fused_dual_s2_conv))

        def make(kg, ok):
            def jfn(p0, p1, p2, p3, ta, ba, tb, bb, mul, add):
                return jf((p0, p1, p2, p3), ta, ba, tb, bb, "average", act=(mul, add),
                          with_stats=True, fold_ok=ok)

            def tfn(p0, p1, p2, p3, ta, ba, tb, bb, mul, add):
                return tf((p0, p1, p2, p3), ta, ba, tb, bb, "average", act=(mul, add),
                          with_stats=True, fold_ok=ok, kernel_geff=kg)
            return jfn, tfn
        return make, [*phases, *w2, *act], 10 if split else 4

    def pcs1(kg, ok):
        def jfn(p0, p1, p2, p3, w, b, mul, add):
            return jpk.fused_phase_conv_s1((p0, p1, p2, p3), w, b, "average", act=(mul, add),
                                           with_stats=True, fold_ok=ok, fold_site="down1")

        def tfn(p0, p1, p2, p3, w, b, mul, add):
            return fused.fused_phase_conv_s1((p0, p1, p2, p3), w, b, "average", act=(mul, add),
                                             with_stats=True, fold_ok=ok, fold_site="down1",
                                             kernel_geff=kg)
        return jfn, tfn

    def upd(kg, ok):
        def jfn(*a):
            return jpk.fused_up_dual_conv(*a, "average", with_stats=True, fold_ok=ok)

        def tfn(*a):
            return fused.fused_up_dual_conv(*a, "average", with_stats=True, fold_ok=ok,
                                            kernel_geff=kg)
        return jfn, tfn

    def std(kg, ok):
        def jfn(x, w, b, mul, add):
            return jck.fused_ico_conv_s2s(x, w, b, 2, "average", act=(mul, add),
                                          with_stats=True)

        def tfn(x, w, b, mul, add):
            return fused.fused_ico_conv_s2s(x, w, b, 2, "average", act=(mul, add),
                                            with_stats=True, kernel_geff=kg)
        return jfn, tfn

    x = c.grid(c.cin)
    return {
        "ds2s": ("ds2", *ds2(True), 2),
        "ds2": ("ds2", *ds2(False), 2),
        "pcs1": ("pcs1_down1", pcs1, [*phases, w2[0], w2[1], *act], 5, 1),
        "upd": ("upd", upd, [x, *w2], 10, 2),
        "std": ("std", std, [c.grid(c.cin, h=4), w2[0], w2[1], *act], 2, 1),
    }


@pytest.mark.parametrize("kernel_geff, fold_ok", _GEFF)
@pytest.mark.parametrize("fn", ["ds2s", "ds2", "pcs1", "upd", "std"])
def test_functions_under_kernel_geff_match_jax(env, interpret, fn, kernel_geff, fold_ok):
    """Gradients through the outputs and the stats; both sides fold outside
    the kernels at the same calls (JAX's Pallas fold kernel under
    ``GENICONET_PALLAS_FOLD=1``, the port's ``stats_geff``), per tap set."""
    env(KERNEL_GEFF=kernel_geff, PALLAS_FOLD="1")
    family, make, inputs, n_out, calls = _functions(_Case(50 + len(kernel_geff), h=4
                                                          if fn in ("ds2s", "ds2") else 2))[fn]
    ok = True if fn == "std" else fold_ok  # the std family has no fold_ok
    jfn, tfn = make(kernel_geff, ok)
    jax_outside, port_calls = _grads_match(jfn, tfn, inputs, n_out, seed=len(fn))
    outside = not kernel_geff_enabled(family, kernel_geff, ok)
    assert jax_outside == outside
    assert port_calls == (calls if outside else 0)


def test_default_kernel_geff_folds_every_family_in_kernel():
    """None, the port's default, folds in-kernel whatever ``fold_ok`` says."""
    for family in ("pcs1_front", "pcs1", "pcs1_up2", "ds2", "upd", "std"):
        assert kernel_geff_enabled(family, None) and kernel_geff_enabled(family, None, False)


# ---------------------------------------------------------------------------
# (e) the chained eval encode, (f) the options' parse
# ---------------------------------------------------------------------------

S, WIDTHS, LATENT = 3, (8, 16, 16), 8


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_chain_eval_encode_matches_jax(env, interpret, model):
    """Eval mode (running BatchNorm statistics): the port's chained encode
    against the JAX model's with ``use_pallas`` under
    ``GENICONET_PHASE_CHAIN=enc``; and it equals the port's unchained one
    within the same tolerance."""
    env(PHASE_CHAIN="enc")
    vae = model == "ico2ico_vae"
    variables = bridge.init_variables(S, WIDTHS, seed=9, random_stats=True, model=model,
                                      latent_features=LATENT)
    x = synthetic_dataset(S, 3, seed=10).inputs
    if vae:
        jm = jax_models.IcoVAE(subdivisions=S, widths=WIDTHS, latent_features=LATENT,
                               use_pallas=True)
    else:
        jm = jax_models.IcoAE(subdivisions=S, widths=WIDTHS, use_pallas=True)
    with mock.patch.object(jpk, "_ds2s_fwd_kernel", wraps=jpk._ds2s_fwd_kernel) as spy:
        ref = jm.apply(j(variables), jnp.asarray(x), method=jm.encode)
    assert spy.called
    outs = {}
    for chain in ("enc", None):
        m = (IcoVAE(S, WIDTHS, LATENT, phase_chain=chain) if vae
             else IcoAE(S, WIDTHS, phase_chain=chain))
        m.load_state_dict(bridge.flax_to_state_dict(variables))
        with torch.no_grad():
            outs[chain] = m.eval().encode(torch.from_numpy(x))
    _close_tree(outs["enc"], ref)
    _close_tree(outs["enc"], [np.asarray(o) for o in outs[None]] if vae else np.asarray(outs[None]))


@pytest.mark.parametrize("value", [None, "0", "1", "enc", "dec"])
def test_phase_chain_enabled_parses_as_jax(monkeypatch, value):
    monkeypatch.setenv("GENICONET_EXPERIMENTAL", "1")
    if value is None:
        monkeypatch.delenv("GENICONET_PHASE_CHAIN", raising=False)
    else:
        monkeypatch.setenv("GENICONET_PHASE_CHAIN", value)
    for part in ("enc", "dec"):
        assert phase_chain_enabled(part, value) == jpk.phase_chain_enabled(part), part


@pytest.mark.parametrize("value", ["", "0", "1", "all", "ds2,std", "pcs1_down0, upd",
                                   "!pcs1_front", "!all"])
def test_kernel_geff_enabled_parses_as_jax(monkeypatch, value):
    monkeypatch.setenv("GENICONET_EXPERIMENTAL", "1")
    monkeypatch.setenv("GENICONET_KERNEL_GEFF", value)
    for family in ("pcs1_front", "pcs1", "pcs1_down0", "pcs1_up1", "ds2", "upd", "std"):
        for allow in (True, False):
            assert (kernel_geff_enabled(family, value, allow)
                    == jpk._kernel_geff_enabled(family, allow)), (family, allow)


@pytest.mark.parametrize("value", ["dec", "1"])
def test_decoder_chain_builds_loads_and_runs(value):
    """``"dec"`` and ``"1"`` build both models, which take the unchained
    model's state dict as it is (the chain has no parameters of its own),
    and decode and train as the unchained models do: one state dict, the
    same decode within 1e-5·max|ref| and the same training loss."""
    for model in ("ico2ico", "ico2ico_vae"):
        vae = model == "ico2ico_vae"
        variables = bridge.init_variables(S, WIDTHS, seed=12, random_stats=True, model=model,
                                          latent_features=LATENT)
        sd = bridge.flax_to_state_dict(variables)
        z = torch.from_numpy(np.random.RandomState(13).randn(
            2, 5 * 2 ** (S - 3), 2 ** (S - 2), LATENT if vae else WIDTHS[2]).astype(np.float32))
        x = torch.from_numpy(synthetic_dataset(S, 2, seed=14).inputs)
        outs, losses = {}, {}
        for chain in (value, None):
            m = (IcoVAE(S, WIDTHS, LATENT, phase_chain=chain) if vae
                 else IcoAE(S, WIDTHS, phase_chain=chain))
            assert set(m.state_dict()) == set(sd)
            m.load_state_dict(sd)
            with torch.no_grad():
                outs[chain] = m.eval().decode(z)
            out = m.train()(x, train=True, sample=False)[0] if vae else m(x, train=True)
            losses[chain] = out.square().sum().item()
        _close_tree(outs[value], np.asarray(outs[None]))
        np.testing.assert_allclose(losses[value], losses[None], rtol=1e-5)


@pytest.mark.parametrize("value", ["2", "encdec", ""])
def test_unknown_phase_chain_raises(value):
    for make in (lambda: IcoAE(S, WIDTHS, phase_chain=value),
                 lambda: IcoVAE(S, WIDTHS, LATENT, phase_chain=value)):
        with pytest.raises(ValueError, match="phase_chain"):
            make()

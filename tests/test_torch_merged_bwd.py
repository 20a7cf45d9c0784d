"""The merged one-pass backward (kernels i, j, k and the ``merged_bwd``
route) against the JAX package's merged route, on the CPU.

The JAX side reads ``GENICONET_EXPERIMENTAL`` and ``GENICONET_MERGED_BWD``
when it traces, so each test sets them (``monkeypatch``) before it calls
into JAX and traces its own functions. Pallas runs in interpret mode.
Inputs come from numpy seeds; tolerances, against each output's max|ref|:

* (a)-(c) the plain versions of ``phase_conv_bwd`` (i), ``up_dual_conv_bwd``
  (j) and ``ico_conv_s2s_bwd`` (k) against ``_phase_conv_bwd``, ``jax.vjp``
  of ``fused_up_dual_conv`` under ``GENICONET_MERGED_BWD=upd`` and
  ``_std_bwd``: 1e-5 in float32 (only the order of the float32 sums
  differs), as the split kernels' tests;
* (d) the four Functions with ``merged_bwd=True`` against ``jax.grad`` of
  the JAX fused functions under ``all``, through the outputs and the stats:
  2e-4, as ``tests/test_torch_backward.py``;
* (e) two steps of ``Trainer(merged_bwd="all")`` against the JAX
  ``Trainer`` on its fused route under ``all``, AE and VAE (eps fixed):
  losses within 1e-5 and grad norms within 1e-4 relative, as the trainer
  tests of the default route;
* (f) the port's merged and split routes on the CPU: every gradient within
  1e-6 (both run the same plain versions over the same fold);
* (g) ``merged_bwd_enabled`` parses as ``_merged_bwd_enabled``.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import geniconet_tpu.nn.models as jax_models
import geniconet_tpu_torch.nn.models as models
from geniconet_tpu.data.pipeline import Batches as JaxBatches
from geniconet_tpu.ops.pallas import conv_kernel as jck
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu.train.config import Config
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.nn.layers import merged_bwd_enabled
from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
from geniconet_tpu_torch.ops.kernels import fused
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk
from geniconet_tpu_torch.train.trainer import Trainer

_ALL = (0, 1, 2, 3)
FAMILIES = ("pcs1", "ds2", "upd", "std")


@pytest.fixture
def merged(monkeypatch):
    """Set the JAX package's merged-backward families (read at trace time)."""
    def setenv(value="all"):
        monkeypatch.setenv("GENICONET_EXPERIMENTAL", "1")
        monkeypatch.setenv("GENICONET_MERGED_BWD", value)
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

    def grid(self, c):
        return self.arr(self.B, 5, self.h, self.w, c)

    def act(self):
        return (self.r.uniform(0.5, 1.5, self.cin).astype(np.float32),
                self.arr(self.cin, scale=0.3))


def j(tree):
    return jax.tree.map(jnp.asarray, tree)


def t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# (a)-(c) the plain versions of kernels i, j and k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("corner_mode", ["average", "zeros"])
@pytest.mark.parametrize("with_act, with_stats", [(True, True), (True, False), (False, True),
                                                  (False, False)])
@pytest.mark.parametrize("out_phases, n_sets", [(_ALL, 1), (_ALL, 2), ((2,), 1), ((2,), 2)])
def test_phase_conv_bwd_plain_matches_pallas(interpret, out_phases, n_sets, with_act, with_stats,
                                             corner_mode):
    c = _Case(3 + n_sets)
    n = len(out_phases)
    raw = [c.grid(c.cin) for _ in range(4)]
    taps = [c.arr(7, c.cin, c.cout, scale=0.3) for _ in range(n_sets)]
    g = [[c.grid(c.cout) for _ in range(n)] for _ in range(n_sets)]
    y = [[c.grid(c.cout) for _ in range(n)] for _ in range(n_sets)] if with_stats else None
    gs = [c.arr(2, c.cout, scale=0.1) for _ in range(n_sets)] if with_stats else None
    act = c.act() if with_act else None
    ref = jpk._phase_conv_bwd(j(raw), j(g), j(y), j(gs), [(jnp.asarray(w), None) for w in taps],
                              corner_mode, out_phases, j(act), with_stats, np.dtype("float32"))
    got = pk.phase_conv_bwd(t(raw), t(g), t(y), t(gs), [(w, None) for w in t(taps)], corner_mode,
                            out_phases, t(act), with_stats, torch.float32)
    _close_tree(got, ref)


@pytest.mark.parametrize("corner_mode", ["average", "zeros"])
@pytest.mark.parametrize("fold", [True, False])
def test_up_dual_conv_bwd_plain_matches_pallas_vjp(merged, interpret, fold, corner_mode):
    """``up_dual_conv_bwd``'s plain version against ``jax.vjp`` of
    ``fused_up_dual_conv(with_stats=True)`` on its merged branch (the stats
    cotangents zero without the fold)."""
    merged("upd")
    c = _Case(9)
    x = c.grid(c.cin)
    ta, ba, tb, bb = (c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout),
                      c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout))
    g = [[c.grid(c.cout) for _ in range(4)] for _ in range(2)]
    gs = [c.arr(2, c.cout, scale=0.1) if fold else np.zeros((2, c.cout), np.float32)
          for _ in range(2)]
    (ya, yb, _, _), vjp = jax.vjp(
        lambda *a: jpk.fused_up_dual_conv(*a, corner_mode, with_stats=True),
        *j((x, ta, ba, tb, bb)))
    dx, dta, dba, dtb, dbb = vjp((*j((tuple(g[0]), tuple(g[1]))), *j(gs)))
    fk = dict(y_groups=[t(list(ya)), t(list(yb))], gs_list=t(gs)) if fold else {}
    got = pk.up_dual_conv_bwd(t(x), t(g), [(w, None) for w in t((ta, tb))], corner_mode, **fk)
    _close_tree(got, [dx, dta, dtb, dba, dbb])


@pytest.mark.parametrize("corner_mode", ["average", "zeros"])
@pytest.mark.parametrize("with_act, with_stats", [(True, True), (True, False), (False, True),
                                                  (False, False)])
def test_ico_conv_s2s_bwd_plain_matches_pallas(interpret, with_act, with_stats, corner_mode):
    c = _Case(21, h=4)
    x, g, y = c.grid(c.cin), c.grid(c.cout), c.grid(c.cout)
    taps = c.arr(7, c.cin, c.cout, scale=0.3)
    gs = c.arr(2, c.cout, scale=0.1)
    act = c.act() if with_act else None
    yy, gg = (y, gs) if with_stats else (None, None)
    ref = jck._std_bwd(*j((x, g, taps, yy, gg)), 2, corner_mode, 1, j(act), with_stats,
                       np.dtype("float32"))
    got = ck.ico_conv_s2s_bwd(*t((x, g, taps, yy, gg)), corner_mode, t(act), with_stats,
                              torch.float32)
    _close_tree(got, ref)


# ---------------------------------------------------------------------------
# (d) the Functions with merged_bwd=True against jax.grad of the merged route
# ---------------------------------------------------------------------------


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _flat(o)]


def _grads_match(jfn, tfn, inputs, n_out_arrays, seed):
    """jax.grad and torch autograd of sum(out · R) over every output (the
    phases and the stats), with the same random R."""
    r = np.random.RandomState(seed)
    jin = j(inputs)
    outs = jax.tree.leaves(jfn(*jin))
    assert len(outs) == n_out_arrays
    weights = [jnp.asarray(r.randn(*o.shape).astype(np.float32)) for o in outs]

    def jloss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jax.tree.leaves(jfn(*a)), weights))

    ref = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*jin)
    tin = [torch.from_numpy(np.array(a)).requires_grad_() for a in inputs]
    loss = sum((o * torch.from_numpy(np.array(w))).sum()
               for o, w in zip(_flat(tfn(*tin)), weights))
    got = torch.autograd.grad(loss, tin)
    for a, b in zip(got, ref):
        _close(a, b, 2e-4)


def test_fused_phase_conv_s1_merged_grads_match_jax(merged, interpret):
    merged()
    c = _Case(11)
    inputs = [*(c.grid(c.cin) for _ in range(4)), c.arr(7, c.cin, c.cout, scale=0.3),
              c.arr(c.cout), *c.act()]

    def jfn(p0, p1, p2, p3, w, b, mul, add):
        return jpk.fused_phase_conv_s1((p0, p1, p2, p3), w, b, "average", act=(mul, add),
                                       with_stats=True)

    def tfn(p0, p1, p2, p3, w, b, mul, add):
        return fused.fused_phase_conv_s1((p0, p1, p2, p3), w, b, "average", act=(mul, add),
                                         with_stats=True, merged_bwd=True)

    _grads_match(jfn, tfn, inputs, 5, seed=1)


def test_fused_dual_s2_conv_merged_grads_match_jax(merged, interpret):
    merged()
    c = _Case(12)
    inputs = [*(c.grid(c.cin) for _ in range(4)), c.arr(7, c.cin, c.cout, scale=0.3),
              c.arr(c.cout), c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout), *c.act()]

    def jfn(p0, p1, p2, p3, ta, ba, tb, bb, mul, add):
        return jpk.fused_dual_s2_conv((p0, p1, p2, p3), ta, ba, tb, bb, "zeros",
                                      act=(mul, add), with_stats=True)

    def tfn(p0, p1, p2, p3, ta, ba, tb, bb, mul, add):
        return fused.fused_dual_s2_conv((p0, p1, p2, p3), ta, ba, tb, bb, "zeros",
                                        act=(mul, add), with_stats=True, merged_bwd=True)

    _grads_match(jfn, tfn, inputs, 4, seed=2)


def test_fused_up_dual_conv_merged_grads_match_jax(merged, interpret):
    merged()
    c = _Case(13)
    inputs = [c.grid(c.cin), c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout),
              c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout)]

    def jfn(*a):
        return jpk.fused_up_dual_conv(*a, "average", with_stats=True)

    def tfn(*a):
        return fused.fused_up_dual_conv(*a, "average", with_stats=True, merged_bwd=True)

    _grads_match(jfn, tfn, inputs, 10, seed=3)


def test_fused_ico_conv_s2s_merged_grads_match_jax(merged, interpret):
    merged()
    c = _Case(14, h=4)
    inputs = [c.grid(c.cin), c.arr(7, c.cin, c.cout, scale=0.3), c.arr(c.cout), *c.act()]

    def jfn(x, w, b, mul, add):
        return jck.fused_ico_conv_s2s(x, w, b, 2, "average", act=(mul, add), with_stats=True)

    def tfn(x, w, b, mul, add):
        return fused.fused_ico_conv_s2s(x, w, b, 2, "average", act=(mul, add), with_stats=True,
                                        merged_bwd=True)

    _grads_match(jfn, tfn, inputs, 2, seed=4)


# ---------------------------------------------------------------------------
# (e) the Trainer on the merged route against the JAX Trainer's
# ---------------------------------------------------------------------------

S, WIDTHS, LATENT, B = 3, (8, 16, 16), 8, 4


def _config(model):
    cfg = Config()
    cfg.model.name = model
    cfg.model.subdivisions, cfg.model.widths, cfg.model.latent_features = S, WIDTHS, LATENT
    cfg.model.use_pallas = True
    cfg.train.batch_size, cfg.train.log_grad_freq = B, 0
    if model == "ico2ico":  # the AE trainer tests' LRs (test_torch_train.py)
        cfg.optim.lr_base, cfg.optim.lr_max = 1e-5, 3e-4
        cfg.optim.step_size_up = cfg.optim.step_size_down = 20
    return cfg


def _fixed_eps(seed):
    """Both packages' reparameterize, patched to one numpy eps."""
    eps = np.random.RandomState(seed).randn(B, 5 * 2 ** (S - 3), 2 ** (S - 2),
                                            LATENT).astype(np.float32)

    def jax_reparam(rng, mu, logvar):
        return jnp.asarray(eps, mu.dtype) * jnp.exp(0.5 * logvar) + mu

    def port_reparam(mu, logvar, generator=None):
        return torch.from_numpy(eps).to(mu.dtype) * torch.exp(0.5 * logvar) + mu

    return (mock.patch.object(jax_models, "reparameterize", jax_reparam),
            mock.patch.object(models, "reparameterize", port_reparam))


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_merged_trainer_matches_jax_trainer_on_its_merged_route(merged, model):
    """Two steps of ``Trainer(merged_bwd="all")`` against the JAX Trainer
    with ``use_pallas`` under ``GENICONET_MERGED_BWD=all`` (every Pallas call
    in interpret mode): at B=4 both models take every block fused, so every
    conv with an input cotangent runs a merged kernel on both sides."""
    merged()
    vae = model == "ico2ico_vae"
    cfg = _config(model)
    ds = synthetic_dataset(S, 2 * B, seed=6)
    variables = bridge.init_variables(S, WIDTHS, seed=7, random_stats=vae, model=model,
                                      latent_features=LATENT)
    patches = [mock.patch.object(jax, "default_backend", lambda: "tpu"),
               pltpu.force_tpu_interpret_mode(), *(_fixed_eps(11) if vae else ())]
    # the JAX merged route's three kernels (i, j's body, k), watched
    spies = [mock.patch.object(mod, name, wraps=getattr(mod, name)) for mod, name in
             ((jpk, "_phase_conv_bwd"), (jpk, "_up_bwd_kernel"), (jck, "_std_bwd"))]
    ref = []
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        watched = [stack.enter_context(p) for p in spies]
        jt = JaxTrainer(cfg)
        assert jt.model.use_pallas
        state = jt.init_state(ds.inputs[:1])
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = state.replace(params=params, opt_state=jt.tx.init(params),
                              batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
        for idx, wt in JaxBatches(ds, B, shuffle=True, seed=8).epoch_indices():
            state, m, _, _ = jt._jit_train_step(state, ds.inputs[idx], ds.targets[idx], wt, 0)
            ref.append({k: float(v) for k, v in jax.device_get(m).items()})
        assert all(w.called for w in watched)
        pt = Trainer(cfg, device="cpu", merged_bwd="all")
        assert pt.model.merged_bwd == "all" and pt.model.pallas_blocks is None
        st = pt.init_state(variables)
        got = [{k: float(v) for k, v in pt.train_step(st, x, y, wt).items()}
               for x, y, wt in Batches(ds, B, shuffle=True, seed=8, device="cpu").epoch()]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for k in ("total", "mse", "kld") if vae else ("total", "mse"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=1e-4)
        assert g["finite"] == r["finite"] == 1.0


# ---------------------------------------------------------------------------
# (f) merged and split routes of the port, (g) the option's parse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_merged_and_split_routes_agree_on_the_cpu(model):
    vae = model == "ico2ico_vae"
    variables = bridge.init_variables(S, WIDTHS, seed=3, random_stats=True, model=model,
                                      latent_features=LATENT)
    x = torch.from_numpy(synthetic_dataset(S, B, seed=4).inputs)
    grads = {}
    for route in (None, "all"):
        m = IcoVAE(S, WIDTHS, LATENT, merged_bwd=route) if vae else IcoAE(S, WIDTHS,
                                                                          merged_bwd=route)
        m.load_state_dict(bridge.flax_to_state_dict(variables))
        out = m(x, train=True, generator=torch.Generator().manual_seed(5)) if vae else m(x, True)
        r = np.random.RandomState(6)
        sum((o * torch.from_numpy(r.randn(*o.shape).astype(np.float32))).sum()
            for o in _flat(out)).backward()
        grads[route] = {k: p.grad for k, p in m.named_parameters()}
    assert set(grads["all"]) == set(grads[None])
    for k, ref in grads[None].items():
        assert (grads["all"][k] - ref).abs().max() <= 1e-6 * ref.abs().max(), k


@pytest.mark.parametrize("value", [None, "0", "1", "all", "ds2,std"])
def test_merged_bwd_enabled_parses_as_jax(monkeypatch, value):
    monkeypatch.setenv("GENICONET_EXPERIMENTAL", "1")
    if value is None:
        monkeypatch.delenv("GENICONET_MERGED_BWD", raising=False)
    else:
        monkeypatch.setenv("GENICONET_MERGED_BWD", value)
    for family in FAMILIES:
        assert merged_bwd_enabled(family, value) == jpk._merged_bwd_enabled(family), family

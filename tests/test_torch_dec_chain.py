"""The decoder's phase chain (kernel n, ``phase_chain="dec"`` and ``"1"``)
against the JAX package's own chain, on the CPU.

The JAX side reads ``GENICONET_EXPERIMENTAL``, ``GENICONET_PHASE_CHAIN``,
``GENICONET_KERNEL_GEFF`` and ``GENICONET_PALLAS_FOLD`` when it traces, so
each test sets them (``monkeypatch``) before it calls into JAX. Pallas runs
in interpret mode. Inputs come from numpy seeds; tolerances, against each
output's max|ref|:

* (a) ``up_pair_fwd_plain``, ``up_pair_dx_plain`` and
  ``up_pair_dtaps_plain`` against ``_updp`` and ``jax.vjp`` of
  ``fused_up_dual_conv_pair`` (its ``_updp_bwd``), with and without stats,
  the fold inside and outside the kernels, both corner modes: all 8 phase
  cotangents, the 4 affine gradients, both dtaps and the bias gradients
  (Σg) within 1e-5 in float32 (only the order of the float32 sums differs);
* (b) ``fused_up_dual_conv_pair`` under ``kernel_geff`` None, ``""`` and
  ``"0"`` against ``jax.grad`` under the same ``GENICONET_KERNEL_GEFF``:
  2e-4, as ``tests/test_torch_backward.py``; spies show where each side
  folds;
* (c) the chained eval decode of both models against the JAX model with
  ``use_pallas`` on its chain: 1e-5, and against the port's unchained
  decode;
* (d) a restricted routing, ``pallas_blocks`` without up1, so that up0's
  pair reaches a plain UpBlock: the eval decode against JAX's on its chain
  (1e-5), and the chained training model's loss, gradients and batch
  statistics against flax's XLA route in float64 (1e-4, as
  ``tests/test_torch_train.py``), also with every block fused.

The ``Trainer`` on the chain is in ``tests/test_torch_dec_chain_train.py``;
the option's parse in ``tests/test_torch_phase_chain.py``. About 115 s in
one process.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import geniconet_tpu.nn.models as jax_models
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
from geniconet_tpu_torch.ops.kernels import fused
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk
from geniconet_tpu_torch.ops.phase import phase_merge
from geniconet_tpu_torch.ops.vertices import pack_target_phases


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


def j(tree):
    return jax.tree.map(jnp.asarray, tree)


def t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


class _Pair:
    """Seeded numpy inputs of one kernel-n call: the pair's 4 + 4 phases
    (B, 5, hp, 2hp, cin) of a level-s grid (2hp, 4hp), its 4 affines and
    the two tap sets; ``grid`` makes level-(s+1) phase tensors."""

    def __init__(self, seed, B=2, hp=2, cin=3, cout=4):
        self.r = np.random.RandomState(seed)
        self.B, self.hp, self.cin, self.cout = B, hp, cin, cout
        self.b0 = [self.grid(cin, hp) for _ in range(4)]
        self.y10 = [self.grid(cin, hp) for _ in range(4)]
        self.aff = [self.r.uniform(0.5, 1.5, cin).astype(np.float32), self.arr(cin, scale=0.3),
                    self.r.uniform(0.5, 1.5, cin).astype(np.float32), self.arr(cin, scale=0.3)]
        self.taps = [self.arr(7, cin, cout, scale=0.3), self.arr(cout),
                     self.arr(7, cin, cout, scale=0.3), self.arr(cout)]

    def arr(self, *shape, scale=1.0):
        return (scale * self.r.randn(*shape)).astype(np.float32)

    def grid(self, c, h):
        return self.arr(self.B, 5, h, 2 * h, c)

    def inputs(self):
        return [*self.b0, *self.y10, *self.aff, *self.taps]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _flat(o)]


# ---------------------------------------------------------------------------
# (a) the plain versions of kernel n
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_stats, fold, corner_mode", [(True, "in", "average"),
                                                           (True, "out", "zeros"),
                                                           (False, None, "zeros"),
                                                           (False, None, "average")])
def test_up_pair_plain_matches_pallas(env, interpret, with_stats, fold, corner_mode):
    """The forward (8 phases, and the stats) against ``_updp``; the 8 phase
    cotangents, 4 affine gradients, both dtaps and bias gradients against
    ``jax.vjp`` of ``fused_up_dual_conv_pair``, whose backward folds
    in-kernel by JAX's built-in set (``upd``) or outside its kernels under
    ``GENICONET_KERNEL_GEFF=0``; the port folds inside its plain versions
    (``y_groups``) or before them (``geff_plain``)."""
    env(KERNEL_GEFF="0" if fold == "out" else None, PALLAS_FOLD=None)
    c = _Pair(80 + 2 * with_stats + (fold == "out") + (corner_mode == "zeros"))
    jb0, jy10, jaff = j(tuple(c.b0)), j(tuple(c.y10)), j(tuple(c.aff))
    sets = [(t(c.taps[0]), t(c.taps[1])), (t(c.taps[2]), t(c.taps[3]))]
    with mock.patch.object(jpk, "_up_pair_fwd_kernel", wraps=jpk._up_pair_fwd_kernel) as spy:
        ref = jpk._updp(jb0, jy10, *jaff, *j(c.taps), corner_mode, with_stats, True)
    assert spy.called
    got = pk.up_pair_fwd_plain(t(c.b0), t(c.y10), t(c.aff), sets, corner_mode, with_stats)
    _close_tree([*got[0], *got[1]] if with_stats else got, list(ref) if with_stats else ref[:2])

    def jfn(b0, y10, aff, ta, ba, tb, bb):
        return jpk.fused_up_dual_conv_pair(b0, y10, aff, ta, ba, tb, bb, corner_mode,
                                           with_stats=with_stats)

    outs, vjp = jax.vjp(jfn, jb0, jy10, jaff, *j(c.taps))
    h = 2 * c.hp
    g = [[c.grid(c.cout, h) for _ in range(4)] for _ in range(2)]
    gs = [c.arr(2, c.cout, scale=0.1) for _ in range(2)]
    with mock.patch.object(jpk, "_up_pair_dx_kernel", wraps=jpk._up_pair_dx_kernel) as dx_spy, \
            mock.patch.object(jpk, "_up_pair_dtaps_kernel",
                              wraps=jpk._up_pair_dtaps_kernel) as dt_spy:
        db0, dy10, daff, dta, dba, dtb, dbb = vjp(
            (*j((tuple(g[0]), tuple(g[1]))), *(j(tuple(gs)) if with_stats else ())))
    assert dx_spy.called and dt_spy.called
    gg, fk = t(g), {}
    if fold == "in":
        fk = dict(y_groups=[t(list(outs[0])), t(list(outs[1]))], gs_list=t(gs))
    elif fold == "out":
        gg = [list(pk.geff_plain(a, t(list(y)), t(s))) for a, y, s in zip(gg, outs[:2], gs)]
    pair = (t(c.b0), t(c.y10), t(c.aff))
    dx = pk.up_pair_dx_plain(gg, *pair, sets, corner_mode, emit_gsum=True, **fk)
    _close_tree(dx[:6], [db0, dy10, *daff])
    _close_tree(dx[6], [dba, dbb])
    _close_tree(pk.up_pair_dtaps_plain(*pair, gg, corner_mode, **fk), [dta, dtb])


def test_up_pair_plain_is_the_up_conv_on_the_joined_grid():
    """The forward and dtaps equal the up conv's plain versions on
    ``phase_merge`` of the joined phases, in float32 and bfloat16; dx's
    join adjoint keeps the up conv's dx in float32 until it is rounded."""
    c = _Pair(90, cin=5, cout=6)
    for dt in (torch.float32, torch.bfloat16):
        b0, y10 = ([torch.from_numpy(a).to(dt) for a in ps] for ps in (c.b0, c.y10))
        aff = t(c.aff)
        sets = [(t(c.taps[0]).to(dt), t(c.taps[1]).to(dt)),
                (t(c.taps[2]).to(dt), t(c.taps[3]).to(dt))]
        x = phase_merge(tuple(pk.pair_join(a, b, aff) for a, b in zip(b0, y10))).contiguous()
        got = pk.up_pair_fwd_plain(b0, y10, aff, sets, "average", True)
        ref = pk.up_dual_conv_fwd_plain(x, sets, "average", True)
        for u, v in zip(_flat(got), _flat(ref)):
            assert torch.equal(u, v)
        g = [[torch.from_numpy(c.grid(c.cout, 2 * c.hp)).to(dt) for _ in range(4)]
             for _ in range(2)]
        for u, v in zip(pk.up_pair_dtaps_plain(b0, y10, aff, g, "average"),
                        pk.up_dual_conv_dtaps_plain(x, g, "average")):
            assert torch.equal(u, v)
        db0, dy10, dm1, da1, dm2, da2, _ = pk.up_pair_dx_plain(g, b0, y10, aff, sets, "average")
        assert da1 is da2 and db0[0].dtype == dt and dm1.dtype == torch.float32


# ---------------------------------------------------------------------------
# (b) the Function under each kernel_geff value against jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_geff", [None, "", "0"])
def test_function_under_kernel_geff_matches_jax(env, interpret, kernel_geff):
    """Gradients of sum(out · R) over the 8 phases and both stats, with the
    same random R, against ``jax.grad`` with ``GENICONET_KERNEL_GEFF`` of
    the same value (unset for None; ``GENICONET_PALLAS_FOLD=1``). None and
    ``""`` fold inside the kernels on both sides (``upd`` is in JAX's
    built-in set), ``"0"`` before them: JAX's Pallas fold kernel and the
    port's ``stats_geff``, once per tap set."""
    env(KERNEL_GEFF=kernel_geff, PALLAS_FOLD="1")
    c = _Pair(100 + len(kernel_geff or "xx"))
    inputs = c.inputs()

    def jfn(*a):
        return jpk.fused_up_dual_conv_pair(a[:4], a[4:8], a[8:12], *a[12:], "average",
                                           with_stats=True)

    def tfn(*a):
        return fused.fused_up_dual_conv_pair(a[:4], a[4:8], a[8:12], *a[12:], "average",
                                             with_stats=True, kernel_geff=kernel_geff)

    r = np.random.RandomState(7)
    jin = j(inputs)
    outs = jax.tree.leaves(jfn(*jin))
    assert len(outs) == 10
    weights = [jnp.asarray(r.randn(*o.shape).astype(np.float32)) for o in outs]

    def jloss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jax.tree.leaves(jfn(*a)), weights))

    with mock.patch.object(jpk, "_fold_geff_kernel", wraps=jpk._fold_geff_kernel) as jspy:
        ref = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*jin)
    tin = [torch.from_numpy(np.array(a)).requires_grad_() for a in inputs]
    with mock.patch.object(fused, "stats_geff", wraps=fused.stats_geff) as tspy, \
            mock.patch.object(fused, "up_pair_dx", wraps=fused.up_pair_dx) as dx_spy:
        loss = sum((o * torch.from_numpy(np.array(w))).sum()
                   for o, w in zip(_flat(tfn(*tin)), weights))
        got = torch.autograd.grad(loss, tin)
    for a, b in zip(got, ref):
        _close(a, b, 2e-4)
    outside = kernel_geff == "0"
    assert jspy.called == outside
    assert tspy.call_count == (2 if outside else 0)
    assert dx_spy.call_count == 1
    assert ("y_groups" in dx_spy.call_args.kwargs) != outside


# ---------------------------------------------------------------------------
# (c) the chained eval decode, (d) a restricted routing
# ---------------------------------------------------------------------------

S, WIDTHS, LATENT = 3, (8, 16, 16), 8
# up1 on the plain route: up0's pair reaches a plain UpBlock
BLOCKS = "conv_in,down0,down1,down2,up0,up2,head"


def _models(vae, **kw):
    if vae:
        return (jax_models.IcoVAE(subdivisions=S, widths=WIDTHS, latent_features=LATENT,
                                  use_pallas=True, pallas_blocks=kw.get("pallas_blocks")),
                lambda chain: IcoVAE(S, WIDTHS, LATENT, phase_chain=chain, **kw))
    return (jax_models.IcoAE(subdivisions=S, widths=WIDTHS, use_pallas=True,
                             pallas_blocks=kw.get("pallas_blocks")),
            lambda chain: IcoAE(S, WIDTHS, phase_chain=chain, **kw))


def _decode_against_jax(model, chain, spied, **kw):
    """The JAX model's eval decode on its chain (spied kernel bodies must
    run), and the port's decode with ``chain`` and unchained."""
    vae = model == "ico2ico_vae"
    variables = bridge.init_variables(S, WIDTHS, seed=9, random_stats=True, model=model,
                                      latent_features=LATENT)
    z = np.random.RandomState(11).randn(3, 5 * 2 ** (S - 3), 2 ** (S - 2),
                                        LATENT if vae else WIDTHS[2]).astype(np.float32)
    jm, make = _models(vae, **kw)
    with mock.patch.object(jpk, spied, wraps=getattr(jpk, spied)) as spy:
        ref = jm.apply(j(variables), jnp.asarray(z), method=jm.decode)
    assert spy.called
    outs = {}
    for ch in (chain, None):
        m = make(ch)
        m.load_state_dict(bridge.flax_to_state_dict(variables))
        with torch.no_grad():
            outs[ch] = m.eval().decode(torch.from_numpy(z))
    return ref, outs


@pytest.mark.parametrize("chain", ["dec", "1"])
@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_chain_eval_decode_matches_jax(env, interpret, model, chain):
    """Eval mode (running BatchNorm statistics): the port's chained decode
    against the JAX model's with ``use_pallas`` under
    ``GENICONET_PHASE_CHAIN``, whose up1 and up2 run kernel n; and it equals
    the port's unchained decode within the same tolerance."""
    env(PHASE_CHAIN=chain)
    with mock.patch.object(fused, "up_pair_fwd", wraps=fused.up_pair_fwd) as spy:
        ref, outs = _decode_against_jax(model, chain, "_up_pair_fwd_kernel")
    assert spy.call_count == 2  # up1 and up2; up0 takes the latent grid
    _close_tree(outs[chain], ref)
    _close_tree(outs[chain], np.asarray(outs[None]))


def test_restricted_routing_eval_decode_matches_jax(env, interpret):
    """``pallas_blocks`` without up1 on the decoder's chain: up0 (fused)
    hands its pair on, up1 joins and interleaves it on the plain route,
    up2 (fused) takes a grid; no pair kernel runs on either side, as in
    ``tests/test_phase_chain.py::test_phase_chain_xla_fallback_matches``."""
    env(PHASE_CHAIN="dec")
    with mock.patch.object(fused, "up_pair_fwd", wraps=fused.up_pair_fwd) as spy:
        ref, outs = _decode_against_jax("ico2ico", "dec", "_up_fwd_kernel",
                                        pallas_blocks=BLOCKS)
    assert not spy.called
    _close_tree(outs["dec"], ref)
    _close_tree(outs["dec"], np.asarray(outs[None]))


def _flax_train_reference(variables, x, tpack, tpoles, w):
    """Loss, gradients and new batch_stats of flax IcoAE(use_pallas=False)
    in train mode, in float64 (``tests/test_torch_train.py``: flax's own
    float32 gradients here carry 2e-3·max|ref| of rounding noise)."""
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        fm = jax_models.IcoAE(subdivisions=S, widths=WIDTHS, use_pallas=False,
                              dtype=jnp.float64)

        def loss(params):
            sse, upd = fm.apply(
                {"params": params, "batch_stats": jax.tree.map(f64, variables["batch_stats"])},
                f64(x), f64(tpack), f64(tpoles), train=True, method=jax_models.IcoAE.recon_sse,
                mutable=["batch_stats"])
            return jnp.sum(sse * f64(w)), upd["batch_stats"]

        (value, stats), grads = jax.value_and_grad(loss, has_aux=True)(
            jax.tree.map(f64, variables["params"]))
        return float(value), *jax.tree.map(np.asarray, (grads, stats))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("blocks, chain", [(BLOCKS, "dec"), (None, "dec"), (None, "1")])
def test_chained_training_model_matches_flax(blocks, chain):
    """The training-mode ``IcoAE`` on the decoder's chain (with
    ``pallas_blocks`` without up1, a pair meets a plain UpBlock in training
    too) against flax's XLA route in float64, as
    ``tests/test_torch_train.py::test_training_model_matches_flax``: the
    same function with the same weights. Loss within 1e-5, every gradient
    and the new batch statistics within 1e-4·max|ref| (a conv bias, whose
    exact gradient is 0, against its taps' scale)."""
    B = 4
    variables = bridge.init_variables(S, WIDTHS, seed=4, random_stats=True)
    ds = synthetic_dataset(S, B, seed=1)
    x, y = ds.inputs, ds.targets
    w = np.random.RandomState(0).uniform(0.5, 1.5, B).astype(np.float32)
    tpack, tpoles = (np.asarray(a) for a in pack_target_phases(torch.from_numpy(y), S))
    ref_loss, ref_grads, ref_stats = _flax_train_reference(variables, x, tpack, tpoles, w)
    m = IcoAE(S, WIDTHS, pallas_blocks=blocks, phase_chain=chain)
    m.load_state_dict(bridge.flax_to_state_dict(variables))
    with mock.patch.object(fused, "up_pair_dtaps", wraps=fused.up_pair_dtaps) as spy:
        sse = m.recon_sse(torch.from_numpy(x), torch.from_numpy(tpack),
                          torch.from_numpy(tpoles), train=True)
        loss = (sse * torch.from_numpy(w)).sum()
        loss.backward()
    assert spy.call_count == (0 if blocks else 2)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    got = _leaves(bridge.state_dict_to_flax({k: p.grad for k, p in m.named_parameters()}))
    ref = _leaves({"params": ref_grads})
    assert set(got) == set(ref)
    for k in ref:
        scale = np.abs(ref[k.replace("['bias']", "['taps']") if "conv" in k else k]).max()
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * scale, k
    stats = _leaves(bridge.state_dict_to_flax(m.state_dict())["batch_stats"])
    for k, v in _leaves(ref_stats).items():
        assert np.abs(stats[k] - v).max() <= 1e-4 * np.abs(v).max(), k

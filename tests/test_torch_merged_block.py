"""The merged blocks (kernels o and p, ``merged_block``) against the JAX
package's own merged-block route, on the CPU.

The JAX side reads ``GENICONET_EXPERIMENTAL``, ``GENICONET_MERGED_BLOCK``,
``GENICONET_MERGED_BWD`` and ``GENICONET_KERNEL_GEFF`` when it traces, so
each test sets them (``monkeypatch``) before it calls into JAX. Pallas runs
in interpret mode (``GENICONET_PALLAS_INTERPRET``, as the JAX package's
merged-block tests run it). Inputs come from numpy seeds; tolerances:

* (a) ``up_block_fwd_plain`` and ``dn_block_fwd_plain`` against
  ``_up_block_fwd_impl`` and ``_dn_block_fwd_impl``: all eight outputs (b0,
  y10, y00, the three stats, mul00, add00), p with and without ``in_act``,
  both corner modes, within 1e-5·max|ref| in float32 (only the order of
  the float32 sums differs);
* (b) ``fused_up_block`` and ``fused_down_block`` gradients against
  ``jax.grad`` of JAX's, under ``merged_bwd`` None and ``"all"`` and
  ``kernel_geff`` None and ``""``: 2e-4 of the overall gradient scale, as
  ``tests/test_merged_block.py`` (a bias before a BatchNorm has gradient 0
  and only rounding noise);
* (c) ``UpBlock`` and ``DownBlock`` with ``merged_block="all"`` against the
  JAX layers under ``GENICONET_MERGED_BLOCK=all``: outputs and running
  statistics within 1e-5·max|ref|, parameter gradients within 2e-4 of the
  overall scale;
* (d) the option's parse and its precedence in the models: no DownBlock
  merges on the encoder's chain, only up0 on the decoder's; eval mode is
  unchanged.

The ``Trainer`` on the route is in ``tests/test_torch_merged_block_train.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.nn import layers as jax_layers
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.nn.layers import DownBlock, UpBlock, merged_block_enabled
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
def interpret(monkeypatch):
    """Pallas interpret mode as the JAX package's own merged-block tests run
    it (``GENICONET_PALLAS_INTERPRET``): the block kernels' (1, C) operands
    are indexed per program, which the bounds-checking TPU interpreter
    rejects and plain interpretation clamps."""
    monkeypatch.setenv("GENICONET_PALLAS_INTERPRET", "1")


def _close(got, ref, tol=1e-5, scale=None):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max() if scale is None else scale
    assert np.abs(got - ref).max() <= tol * scale, (np.abs(got - ref).max(), scale)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [out]


def t(a):
    return torch.from_numpy(np.array(a))


class _Block:
    """Seeded numpy inputs of one merged block: the block's input (a level-s
    grid for o, its 4 parity phases for p), the three convs' taps and
    biases, bn00's gamma and beta, and a pending act."""

    def __init__(self, seed, s, up, B=2, cin=3, F=4):
        self.r = np.random.RandomState(seed)
        h, w = 2**s, 2 ** (s + 1)
        self.s, self.cin, self.F = s, cin, F
        if up:
            self.x = [self.arr(B, 5, h, w, cin)]
        else:
            self.x = [self.arr(B, 5, h // 2, w // 2, cin) for _ in range(4)]
        self.params = [self.arr(7, cin, F, scale=0.3), self.arr(F, scale=0.3),
                       self.arr(7, cin, F, scale=0.3), self.arr(F, scale=0.3),
                       self.arr(7, F, F, scale=0.3), self.arr(F, scale=0.3),
                       self.r.uniform(0.5, 1.5, F).astype(np.float32), self.arr(F, scale=0.3)]
        self.act = [self.r.uniform(0.5, 1.5, cin).astype(np.float32), self.arr(cin, scale=0.3)]

    def arr(self, *shape, scale=1.0):
        return (scale * self.r.randn(*shape)).astype(np.float32)

    def tap_sets(self):
        p = [t(a) for a in self.params[:6]]
        return [(p[0], p[1]), (p[2], p[3]), (p[4], p[5])]


# ---------------------------------------------------------------------------
# (a) the plain versions of o and p against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("corner_mode", ["average", "zeros"])
def test_up_block_plain_matches_pallas(env, interpret, corner_mode):
    """``up_block_fwd_plain`` against ``_up_block_fwd_impl``: b0, y10 and
    y00 (4 phases each), s00, s01, s10, mul00, add00."""
    env()
    c = _Block(10 + (corner_mode == "zeros"), 2, up=True)
    with mock.patch.object(jpk, "_up_block_kernel", wraps=jpk._up_block_kernel) as spy:
        ref = jpk._up_block_fwd_impl(jnp.asarray(c.x[0]), *map(jnp.asarray, c.params),
                                     corner_mode, 1e-5)
    assert spy.called
    got = pk.up_block_fwd_plain(t(c.x[0]), c.tap_sets(), t(c.params[6]), t(c.params[7]),
                                corner_mode)
    assert len(got) == len(ref) == 8
    for a, b in zip(_flat(got), jax.tree.leaves(ref)):
        _close(a, b)


@pytest.mark.parametrize("with_act, corner_mode", [(True, "average"), (False, "average"),
                                                   (True, "zeros")])
def test_dn_block_plain_matches_pallas(env, interpret, with_act, corner_mode):
    """``dn_block_fwd_plain`` against ``_dn_block_fwd_impl``, with and
    without the pending act: b0, y10, y00, s00, s01, s10, mul00, add00."""
    env()
    c = _Block(20 + 2 * with_act + (corner_mode == "zeros"), 3, up=False)
    act = c.act if with_act else (None, None)
    with mock.patch.object(jpk, "_dn_block_kernel", wraps=jpk._dn_block_kernel) as spy:
        ref = jpk._dn_block_fwd_impl(tuple(map(jnp.asarray, c.x)), *map(jnp.asarray, c.params),
                                     *(None if a is None else jnp.asarray(a) for a in act),
                                     corner_mode, 1e-5)
    assert spy.called
    got = pk.dn_block_fwd_plain([t(a) for a in c.x], c.tap_sets(), t(c.params[6]),
                                t(c.params[7]), [t(a) for a in c.act] if with_act else None,
                                corner_mode)
    assert len(got) == len(ref) == 8
    for a, b in zip(_flat(got), jax.tree.leaves(ref)):
        _close(a, b)


# ---------------------------------------------------------------------------
# (b) the Functions' gradients against jax.grad of JAX's
# ---------------------------------------------------------------------------

ROUTES = [(None, None), ("all", None), (None, "")]


def _grads_match(jfn, tfn, inputs, seed):
    """Gradients of sum(out · R) over every output (R random, seeded) of
    ``jfn`` (jax.grad) and ``tfn`` (torch autograd) at ``inputs``, within
    2e-4 of the overall gradient scale."""
    jin = [jnp.asarray(a) for a in inputs]
    outs = jax.tree.leaves(jfn(*jin))
    r = np.random.RandomState(seed)
    weights = [r.randn(*o.shape).astype(np.float32) for o in outs]

    def jloss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jax.tree.leaves(jfn(*a)), weights))

    ref = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*jin)
    tin = [t(a).requires_grad_() for a in inputs]
    got_outs = _flat(tfn(*tin))
    assert len(got_outs) == len(outs)
    loss = sum((o * t(w)).sum() for o, w in zip(got_outs, weights))
    got = torch.autograd.grad(loss, tin)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref)
    for a, b in zip(got, ref):
        _close(a, b, 2e-4, scale)


@pytest.mark.parametrize("merged_bwd, kernel_geff", ROUTES)
def test_fused_up_block_grads_match_jax(env, interpret, merged_bwd, kernel_geff):
    """``fused_up_block`` against ``jax.grad`` of JAX's under the same
    ``GENICONET_MERGED_BWD`` / ``GENICONET_KERNEL_GEFF``; spies: the merged
    backward kernels (i, j) run exactly on the merged route, and the fold
    outside the kernels (l, for ``pcs1``) exactly under ``""``."""
    env(MERGED_BWD=merged_bwd, KERNEL_GEFF=kernel_geff)
    c = _Block(30 + len(merged_bwd or "") + len(kernel_geff or "xx"), 2, up=True)

    def jfn(x, *p):
        return jpk.fused_up_block(x, *p, "average")

    def tfn(x, *p):
        return fused.fused_up_block(x, *p, "average", merged_bwd=merged_bwd,
                                    kernel_geff=kernel_geff)

    with mock.patch.object(fused, "up_dual_conv_bwd", wraps=fused.up_dual_conv_bwd) as j, \
            mock.patch.object(fused, "phase_conv_bwd", wraps=fused.phase_conv_bwd) as i, \
            mock.patch.object(fused, "stats_geff", wraps=fused.stats_geff) as fold:
        _grads_match(jfn, tfn, [*c.x, *c.params], 3)
    assert i.called == j.called == (merged_bwd == "all")
    assert fold.called == (kernel_geff == "")


@pytest.mark.parametrize("merged_bwd, kernel_geff", ROUTES)
def test_fused_down_block_grads_match_jax(env, interpret, merged_bwd, kernel_geff):
    """``fused_down_block`` with a pending act against ``jax.grad`` of
    JAX's (the act's (mul, add) get gradients too); spies: kernels i and k
    on the merged route, l under ``""``."""
    env(MERGED_BWD=merged_bwd, KERNEL_GEFF=kernel_geff)
    c = _Block(40 + len(merged_bwd or "") + len(kernel_geff or "xx"), 3, up=False)

    def jfn(x0, x1, x2, x3, *p):
        return jpk.fused_down_block((x0, x1, x2, x3), *p[:8], 3, in_act=p[8:],
                                    corner_mode="average")

    def tfn(x0, x1, x2, x3, *p):
        return fused.fused_down_block((x0, x1, x2, x3), *p[:8], 3, in_act=p[8:],
                                      merged_bwd=merged_bwd, kernel_geff=kernel_geff)

    with mock.patch.object(fused, "ico_conv_s2s_bwd", wraps=fused.ico_conv_s2s_bwd) as k, \
            mock.patch.object(fused, "phase_conv_bwd", wraps=fused.phase_conv_bwd) as i, \
            mock.patch.object(fused, "stats_geff", wraps=fused.stats_geff) as fold:
        _grads_match(jfn, tfn, [*c.x, *c.params, *c.act], 4)
    assert i.called == k.called == (merged_bwd == "all")
    assert fold.called == (kernel_geff == "")


def test_fused_down_block_checks_its_level():
    c = _Block(50, 3, up=False)
    with pytest.raises(ValueError):
        fused.fused_down_block([t(a) for a in c.x], *[t(a) for a in c.params], 2)


# ---------------------------------------------------------------------------
# (c) the merged blocks against the JAX layers
# ---------------------------------------------------------------------------


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _layer_matches_jax(env, jblk, make, x):
    """Train mode, the JAX layer under ``GENICONET_MERGED_BLOCK=all`` (its
    block kernel must run) and the port's block with ``merged_block="all"``
    on the same weights: the output, the new running statistics, and the
    parameter gradients of sum(out · R)."""
    env(MERGED_BLOCK="all")
    jx = jnp.asarray(x)
    variables = jblk.init(jax.random.PRNGKey(0), jx, train=True)
    r = np.random.RandomState(5)
    spied = "_up_block_kernel" if isinstance(jblk, jax_layers.UpBlock) else "_dn_block_kernel"
    with mock.patch.object(jpk, spied, wraps=getattr(jpk, spied)) as spy:
        out, upd = jblk.apply(variables, jx, train=True, mutable=["batch_stats"])
        ct = r.randn(*out.shape).astype(np.float32)

        def loss(params):
            o, _ = jblk.apply({"params": params, "batch_stats": variables["batch_stats"]}, jx,
                              train=True, mutable=["batch_stats"])
            return jnp.vdot(o, jnp.asarray(ct))

        ref_grads = jax.grad(loss)(variables["params"])
    assert spy.called
    blk = make()
    blk.load_state_dict(bridge.flax_to_state_dict(jax.tree.map(np.asarray, variables)))
    with mock.patch.object(fused, "up_block_fwd", wraps=fused.up_block_fwd) as o, \
            mock.patch.object(fused, "dn_block_fwd", wraps=fused.dn_block_fwd) as p:
        got = blk(t(x), train=True)
        (got * t(ct)).sum().backward()
    assert o.call_count + p.call_count == 1
    _close(got, out)
    new = _leaves(bridge.state_dict_to_flax(blk.state_dict())["batch_stats"])
    ref = _leaves(upd["batch_stats"])
    assert set(new) == set(ref)
    for k in ref:
        _close(new[k], ref[k])
    got_grads = _leaves(bridge.state_dict_to_flax({k: q.grad for k, q in
                                                   blk.named_parameters()})["params"])
    ref_grads = _leaves(ref_grads)
    assert set(got_grads) == set(ref_grads)
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for k in ref_grads:
        _close(got_grads[k], ref_grads[k], 2e-4, scale)


def test_upblock_merged_matches_jax_layer(env, interpret):
    x = np.random.RandomState(6).randn(2, 5, 4, 8, 6).astype(np.float32)
    _layer_matches_jax(env, jax_layers.UpBlock(8, 2, use_pallas=True), lambda: UpBlock(
        6, 8, merged_block="all", name="up0"), x)


def test_downblock_merged_matches_jax_layer(env, interpret):
    x = np.random.RandomState(7).randn(2, 5, 8, 16, 6).astype(np.float32)
    _layer_matches_jax(env, jax_layers.DownBlock(8, 3, use_pallas=True), lambda: DownBlock(
        6, 8, merged_block="all", name="down0"), x)


# ---------------------------------------------------------------------------
# (d) the option's parse and precedence
# ---------------------------------------------------------------------------


def test_merged_block_enabled_parses_as_jax():
    """None, "" and "0" off; "1" and "all" every block; a comma list the
    blocks it names (``phase_kernel.py:merged_block_enabled``)."""
    for off in (None, "", "0"):
        assert not merged_block_enabled("up0", off)
    for on in ("1", "all"):
        assert merged_block_enabled("down2", on)
    assert merged_block_enabled("up1", "up0, up1")
    assert not merged_block_enabled("up2", "up0,up1")
    assert not merged_block_enabled("down0", "up0,up1")


def _count_blocks(model, train=True, **kw):
    """(o, p) launches of one forward (and backward in train mode) of an
    s=4 model at small widths, and its output."""
    s, widths = 4, (8, 16, 16)
    vae = model == "ico2ico_vae"
    variables = bridge.init_variables(s, widths, seed=8, random_stats=True, model=model,
                                      latent_features=8)
    net = IcoVAE(s, widths, 8, **kw) if vae else IcoAE(s, widths, **kw)
    net.load_state_dict(bridge.flax_to_state_dict(variables))
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 5 * 2**s, 2 ** (s + 1), 3)
                         .astype(np.float32))
    with mock.patch.object(fused, "up_block_fwd", wraps=fused.up_block_fwd) as o, \
            mock.patch.object(fused, "dn_block_fwd", wraps=fused.dn_block_fwd) as p:
        if train:
            out = net(x, train=True)
            sum(r.float().sum() for r in _flat(out)).backward()
        else:
            with torch.no_grad():
                out = net.eval()(x, sample=False) if vae else net.eval()(x)
    return o.call_count, p.call_count, out


@pytest.mark.parametrize("chain, want", [(None, (3, 3)), ("enc", (3, 0)), ("dec", (1, 3)),
                                         ("1", (1, 0))])
def test_merged_block_precedence(chain, want):
    """The AE at s=4 with ``merged_block="all"``: the encoder's chain wins
    over the merged block (every DownBlock there is chained), and on the
    decoder's chain only up0 (which takes the latent grid) merges; a comma
    list merges the blocks it names."""
    assert _count_blocks("ico2ico", merged_block="all", phase_chain=chain)[:2] == want
    if chain is None:
        assert _count_blocks("ico2ico", merged_block="up2,down0")[:2] == (1, 1)


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_eval_mode_is_unchanged(model):
    """Eval mode (running statistics) never merges, and computes what the
    unmerged model does."""
    o, p, got = _count_blocks(model, train=False, merged_block="all")
    assert o == p == 0
    ref = _count_blocks(model, train=False)[2]
    for a, b in zip(_flat(got), _flat(ref)):
        assert torch.equal(a, b)

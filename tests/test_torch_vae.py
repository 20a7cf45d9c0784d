"""The port's VAE slice against the JAX package, on the CPU.

Inputs come from numpy seeds and weights through ``bridge.py``; JAX's Pallas
calls run in interpret mode. Tolerances, each against the reference's
max|ref| unless stated:

* the head's backward (kernel e's plain version, and the ``fused_pair_head``
  Function through autograd) against ``jax.vjp`` of JAX's
  ``fused_pair_head``, every output: 1e-5 in float32 (only the order of the
  float32 sums differs); 1e-2 in bfloat16 (the rounding points are the
  same, but a sum in another order can round the head's pre-activation to
  the neighbouring bf16 value, one bf16 step being 3.9e-3 relative);
* ``ops/mesh_math.py``: tables equal; values and gradients 1e-5;
* the P2P, KLD and P2P+KLD losses: values 1e-6 relative, gradients 1e-5;
* ``IcoVAE`` in eval mode against flax ``IcoVAE(use_pallas=False)`` 1e-4;
  in train mode against flax in float64 (as ``test_torch_train.py`` does for
  the AE: flax's own float32 gradients carry up to 2e-3 of rounding noise
  there): loss, every gradient leaf and the new batch statistics 1e-4;
* the VAE ``Trainer`` against the JAX ``Trainer`` on its XLA route (three
  steps) and on its fused route in interpret mode (two steps, with
  ``_phead_bwd``): losses and the metrics mse / cos / lap / kld within 1e-5
  relative, grad norms within 1e-4 relative; and the AE ``Trainer`` with
  normal and Laplacian factors, the same way.

JAX's PRNG cannot be reproduced in torch, so eps is held fixed on both sides
by patching ``reparameterize`` in both packages for the test.
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
from geniconet_tpu.geometry import ico as jax_ico
from geniconet_tpu.losses import p2p as jax_p2p
from geniconet_tpu.nn.models import IcoVAE as FlaxIcoVAE
from geniconet_tpu.ops import mesh_math as jax_mm
from geniconet_tpu.ops.pallas.phase_kernel import fused_pair_head as jax_fused_pair_head
from geniconet_tpu.ops.vertices import grid_to_vertices as jax_grid_to_vertices
from geniconet_tpu.train.config import Config
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.app.server import handle_api
from geniconet_tpu_torch.app.state import AppState
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.losses import p2p
from geniconet_tpu_torch.nn.models import IcoVAE
from geniconet_tpu_torch.ops import mesh_math as mm
from geniconet_tpu_torch.ops.kernels.fused import fused_pair_head
from geniconet_tpu_torch.ops.kernels.phase_kernel import pair_head_bwd_plain
from geniconet_tpu_torch.train.trainer import Trainer

S, WIDTHS, LATENT, B = 3, (8, 16, 16), 8, 4


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (what, err, scale)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# kernel e: the head's backward without a target
# ---------------------------------------------------------------------------


def _head_inputs(s, C=16, F=3, seed=0):
    r = np.random.RandomState(seed)
    h, w = 2 ** (s - 1), 2**s
    b0 = [r.randn(3, 5, h, w, C).astype(np.float32) for _ in range(4)]
    y10 = [r.randn(3, 5, h, w, C).astype(np.float32) for _ in range(4)]
    aff = [(r.rand(C) + 0.5).astype(np.float32), r.randn(C).astype(np.float32),
           (r.rand(C) + 0.5).astype(np.float32), r.randn(C).astype(np.float32)]
    W = (r.randn(C, F) * C**-0.5).astype(np.float32)
    bias = (0.3 * r.randn(F)).astype(np.float32)
    g = [r.randn(3, 5, h, w, F).astype(np.float32) for _ in range(4)]
    return b0, y10, aff, W, bias, g


@pytest.mark.parametrize("s, dtype", [(2, "float32"), (3, "float32"), (3, "bfloat16")])
def test_head_backward_matches_jax_vjp(s, dtype):
    b0, y10, aff, W, bias, g = _head_inputs(s, seed=s)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tol = 1e-2 if dtype == "bfloat16" else 1e-5

    def f(b0, y10, m1, a1, m2, a2, W, bias):
        return jax_fused_pair_head(b0, y10, (m1, a1, m2, a2), W, bias)

    args = ([jnp.asarray(a, jdt) for a in b0], [jnp.asarray(a, jdt) for a in y10],
            *[jnp.asarray(a) for a in aff], jnp.asarray(W, jdt), jnp.asarray(bias, jdt))
    with pltpu.force_tpu_interpret_mode():
        ref_out, vjp = jax.vjp(f, *args)
        rb0, ry10, *rest = vjp(tuple(jnp.asarray(a) for a in g))
    # JAX's order: 8 phases, d_mul1, d_add1, d_mul2, d_add2, dW, dbias
    ref = [np.asarray(r, np.float32) for r in (*rb0, *ry10, *rest)]

    tin = [_t(a).to(tdt) for a in (*b0, *y10)]
    taff = [_t(a) for a in aff]
    tW, tb = _t(W).to(tdt), _t(bias).to(tdt)
    tg = tuple(_t(a) for a in g)
    db0, dy10, dW, dbias, *daff = pair_head_bwd_plain(tg, tin[:4], tin[4:], taff, tW, tb)
    plain = [*db0, *dy10, *daff, dW, dbias]
    assert [a.dtype for a in plain] == [tdt] * 8 + [torch.float32] * 4 + [tdt] * 2
    for k, (a, r) in enumerate(zip(plain, ref, strict=True)):
        _close(a.float().numpy(), r, tol, f"plain output {k}")

    leaves = [t.clone().requires_grad_() for t in (*tin, *taff, tW, tb)]
    outs = fused_pair_head(leaves[:4], leaves[4:8], leaves[8:12], leaves[12], leaves[13])
    for o, r in zip(outs, ref_out, strict=True):
        _close(o.detach().numpy(), np.asarray(r), tol, "forward")
    grads = torch.autograd.grad(outs, leaves, tg)
    for k, (a, r) in enumerate(zip(grads, ref, strict=True)):
        _close(a.float().numpy(), r, tol, f"Function output {k}")


# ---------------------------------------------------------------------------
# mesh math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_grid_stencil_tables_equal_the_jax_module(s):
    got, ref = mm._grid_stencil_tables(s), jax_mm._grid_stencil_tables(s)
    np.testing.assert_array_equal(got["lap_mask"], ref["lap_mask"])
    np.testing.assert_array_equal(got["deg"], ref["deg"])
    assert list(got["pair_masks"]) == list(ref["pair_masks"])  # same order: same sums
    for k in ref["pair_masks"]:
        np.testing.assert_array_equal(got["pair_masks"][k], ref["pair_masks"][k])
    assert got["pole_pairs"] == ref["pole_pairs"]
    if s <= 3:
        for k, v in jax_mm._gather_transpose_tables(s).items():
            np.testing.assert_array_equal(mm._gather_transpose_tables(s)[k], v, err_msg=k)


def _vjp_pair(f_port, f_jax, x, seed):
    """Values and input gradients (for a random cotangent) of both."""
    ref, vjp = jax.vjp(f_jax, jnp.asarray(x))
    cts = jax.tree.map(lambda a: np.random.RandomState(seed).randn(*a.shape).astype(np.float32),
                       ref)
    (ref_g,) = vjp(cts)
    xt = _t(x).requires_grad_()
    got = f_port(xt)
    got_l, cts_l = (list(got), list(cts)) if isinstance(got, tuple) else ([got], [cts])
    pairs = [(o, _t(c)) for o, c in zip(got_l, cts_l) if o.requires_grad]  # not the zero poles
    (got_g,) = torch.autograd.grad([o for o, _ in pairs], [xt], [c for _, c in pairs])
    ref_l = list(ref) if isinstance(ref, tuple) else [ref]
    return [g.detach().numpy() for g in got_l], ref_l, got_g.numpy(), np.asarray(ref_g)


@pytest.mark.parametrize("s", [2, 3])
def test_mesh_math_values_and_gradients_match_jax(s):
    h, w = jax_ico.chart_shape(s)
    r = np.random.RandomState(s)
    xc = r.randn(B, 5, h, w, 3).astype(np.float32)
    v = np.asarray(jax_grid_to_vertices(jnp.asarray(xc.reshape(B, 5 * h, w, 3)), s))
    faces = jax_ico.get_ico_faces(s)
    cases = [
        (lambda x: mm.face_normals(x, faces, normalize=True),
         lambda x: jax_mm.face_normals(x, jnp.asarray(faces), normalize=True), v),
        (lambda x: mm.vertex_normals_grid(x, s), lambda x: jax_mm.vertex_normals_grid(x, s), xc),
        (lambda x: mm.laplacian_grid(x, s), lambda x: jax_mm.laplacian_grid(x, s), xc),
        (lambda x: mm.vertex_normals(x, s), lambda x: jax_mm.vertex_normals(x, s), v),
        (lambda x: mm.laplacian(x, s), lambda x: jax_mm.laplacian(x, s), v),
    ]
    for k, (fp, fj, x) in enumerate(cases):
        got, ref, got_g, ref_g = _vjp_pair(fp, fj, x, seed=k)
        for a, b in zip(got, ref):
            _close(a, b, 1e-5, f"case {k} value")
        _close(got_g, ref_g, 1e-5, f"case {k} gradient")


@pytest.mark.parametrize("s", [1, 2, 3])
def test_gather_transpose_backwards_match_jax(s):
    """The three gathers whose backward is an inverse-table gather, one at
    a time, against the JAX custom VJPs."""
    r = np.random.RandomState(10 + s)
    V, F = jax_ico.num_vertices(s), jax_ico.num_faces(s)
    cases = [
        (lambda x: mm._FaceCornerTakes.apply(x, s), lambda x: jax_mm._face_corner_takes(x, s),
         r.randn(2, V, 3)),
        (lambda x: mm._VfMaskedTake.apply(x, s), lambda x: jax_mm._vf_masked_take(x, s),
         r.randn(2, F, 3)),
        (lambda x: mm._NbrMaskedTake.apply(x, s), lambda x: jax_mm._nbr_masked_take(x, s),
         r.randn(2, V, 3)),
    ]
    for k, (fp, fj, x) in enumerate(cases):
        got, ref, got_g, ref_g = _vjp_pair(fp, fj, x.astype(np.float32), seed=k)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
        _close(got_g, ref_g, 1e-6, f"gather {k} gradient")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs(s=S, seed=0):
    r = np.random.RandomState(seed)
    grid = r.uniform(-1, 1, (B, 5 * 2**s, 2 ** (s + 1), 3)).astype(np.float32)
    target = synthetic_dataset(s, B, seed=seed + 1).targets
    mu = r.randn(B, 5, 2, LATENT).astype(np.float32)
    logvar = (0.3 * r.randn(B, 5, 2, LATENT)).astype(np.float32)
    w = np.array([1.0, 0.5, 2.0, 0.0], np.float32)
    return grid, target, mu, logvar, w


@pytest.mark.parametrize("allow_grid", [True, False])
def test_p2pkld_loss_matches_jax(allow_grid):
    grid, target, mu, logvar, w = _loss_inputs()
    kf = p2p.kl_factor_at_epoch(60, step_size=25, gamma=0.9)
    np.testing.assert_allclose(kf, float(jax_p2p.kl_factor_at_epoch(60, 1.0, 25, 0.9)),
                               rtol=1e-7)

    def jax_fn(g, m, lv):
        loss, met = jax_p2p.p2pkld_loss(g, m, lv, jnp.asarray(target), S,
                                        jax_p2p.LossFactors.vae(), kf, jnp.asarray(w),
                                        allow_grid=allow_grid)
        return loss, met

    (ref, ref_m), ref_g = jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(grid), jnp.asarray(mu), jnp.asarray(logvar))
    leaves = [_t(a).requires_grad_() for a in (grid, mu, logvar)]
    got, got_m = p2p.p2pkld_loss(*leaves, _t(target), S, p2p.LossFactors.vae(), kf, _t(w),
                                 allow_grid=allow_grid)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    assert set(got_m) == set(ref_m) == {"mse", "cos", "lap", "recon", "kld"}
    for k in ref_m:
        np.testing.assert_allclose(got_m[k].item(), float(ref_m[k]), rtol=1e-6, err_msg=k)
    for t, r in zip(leaves, ref_g):
        _close(t.grad.numpy(), r, 1e-5, "gradient")
    # the KLD alone, unweighted
    np.testing.assert_allclose(p2p.kld_loss(_t(mu), _t(logvar)).item(),
                               float(jax_p2p.kld_loss(jnp.asarray(mu), jnp.asarray(logvar))),
                               rtol=1e-6)


def test_p2p_loss_routes_agree():
    """The grid-stencil and vertex-table routes of the normal and Laplacian
    terms give one loss and one gradient."""
    grid, target, *_, w = _loss_inputs(seed=5)
    out = []
    for allow_grid in (True, False):
        g = _t(grid).requires_grad_()
        loss, _ = p2p.p2p_loss(g, _t(target), S, p2p.LossFactors.vae(), _t(w),
                               allow_grid=allow_grid)
        loss.backward()
        out.append((loss.item(), g.grad.numpy()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    _close(out[0][1], out[1][1], 1e-5)


# ---------------------------------------------------------------------------
# the model and the bridge
# ---------------------------------------------------------------------------


def _flax_vae(dtype=jnp.float32):
    return FlaxIcoVAE(subdivisions=S, widths=WIDTHS, latent_features=LATENT, use_pallas=False,
                      dtype=dtype)


def _flax_variables(seed=0):
    shapes = jax.eval_shape(_flax_vae().init, {"params": jax.random.PRNGKey(0),
                                               "reparam": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 5 * 2**S, 2 ** (S + 1), 3)))
    r = np.random.RandomState(seed)
    return jax.tree.map(lambda a: r.randn(*a.shape).astype(np.float32), shapes)


def test_bridge_roundtrips_the_vae_tree():
    variables = _flax_variables()
    sd = bridge.flax_to_state_dict(variables)
    model_sd = IcoVAE(S, WIDTHS, LATENT).state_dict()
    assert set(sd) == set(model_sd) and len(sd) == len(jax.tree_util.tree_leaves(variables))
    for k, v in sd.items():
        assert v.shape == model_sd[k].shape, k
    back, want = _leaves(bridge.state_dict_to_flax(sd)), _leaves(variables)
    assert set(back) == set(want)
    assert any("['mu_bn']['BatchNorm_0']" in k for k in want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    ours = _leaves(bridge.init_variables(S, WIDTHS, seed=0, model="ico2ico_vae",
                                         latent_features=LATENT))
    assert set(ours) == set(want)
    for k in want:
        assert ours[k].shape == want[k].shape, k


def _vae_variables(seed):
    return bridge.init_variables(S, WIDTHS, seed=seed, random_stats=True, model="ico2ico_vae",
                                 latent_features=LATENT)


def test_eval_encode_and_decode_match_flax():
    variables = _vae_variables(1)
    x = synthetic_dataset(S, B, seed=2).inputs
    fm = _flax_vae()
    ref_mu, ref_lv = fm.apply(variables, jnp.asarray(x), method="encode")
    m = IcoVAE(S, WIDTHS, LATENT)
    m.load_state_dict(bridge.flax_to_state_dict(variables))
    m.eval()
    with torch.no_grad():
        mu, lv = m.encode(_t(x))
        _close(mu.numpy(), ref_mu, 1e-4, "mu")
        _close(lv.numpy(), ref_lv, 1e-4, "logvar")
        z = np.asarray(ref_mu) + 0.5
        _close(m.decode(_t(z)).numpy(), fm.apply(variables, jnp.asarray(z), method="decode"),
               1e-4, "decode")


def _eps(seed=9):
    return np.random.RandomState(seed).randn(B, 5 * 2 ** (S - 3), 2 ** (S - 2),
                                             LATENT).astype(np.float32)


def _fixed_eps(eps):
    """Both packages' reparameterize, patched to use ``eps``."""
    def jax_reparam(rng, mu, logvar):
        return jnp.asarray(eps, mu.dtype) * jnp.exp(0.5 * logvar) + mu

    def port_reparam(mu, logvar, generator=None):
        return torch.from_numpy(eps).to(mu.dtype) * torch.exp(0.5 * logvar) + mu

    return (mock.patch.object(jax_models, "reparameterize", jax_reparam),
            mock.patch.object(models, "reparameterize", port_reparam))


@pytest.mark.parametrize("blocks", [None, "conv_in,heads,up0,head"])
def test_training_vae_matches_flax(blocks):
    """Train-mode forward, a linear loss of (recon, mu, logvar) with random
    weights, and its gradients, against flax in float64."""
    variables = _vae_variables(4)
    x = synthetic_dataset(S, B, seed=1).inputs
    eps = _eps()
    r = np.random.RandomState(5)
    cts = [r.randn(B, 5 * 2**S, 2 ** (S + 1), 3), r.randn(*eps.shape), r.randn(*eps.shape)]
    jax_patch, port_patch = _fixed_eps(eps)
    with jax.enable_x64(True), jax_patch:
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        fm = _flax_vae(jnp.float64)

        def loss(params):
            (recon, mu, lv), upd = fm.apply(
                {"params": params, "batch_stats": jax.tree.map(f64, variables["batch_stats"])},
                f64(x), train=True, sample=True, rngs={"reparam": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            total = sum(jnp.sum(a * f64(c)) for a, c in zip((recon, mu, lv), cts))
            return total, upd["batch_stats"]

        (ref_loss, ref_stats), ref_grads = jax.value_and_grad(loss, has_aux=True)(
            jax.tree.map(f64, variables["params"]))
    m = IcoVAE(S, WIDTHS, LATENT, pallas_blocks=blocks)
    m.load_state_dict(bridge.flax_to_state_dict(variables))
    with port_patch:
        outs = m(_t(x), train=True)
    total = sum((a * _t(c)).sum() for a, c in zip(outs, cts))
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref_loss), rtol=1e-4)
    got = _leaves(bridge.state_dict_to_flax({k: p.grad for k, p in m.named_parameters()}))
    ref = _leaves({"params": jax.tree.map(np.asarray, ref_grads)})
    assert set(got) == set(ref)
    for k in ref:
        # a conv's bias feeds a BatchNorm, so its exact gradient is 0 and
        # both sides hold rounding noise: hold it against its taps' scale
        scale = np.abs(ref[k.replace("['bias']", "['taps']") if "conv" in k else k]).max()
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * scale, k
    got_s = _leaves(bridge.state_dict_to_flax(m.state_dict())["batch_stats"])
    for k, v in _leaves(jax.tree.map(np.asarray, ref_stats)).items():
        _close(got_s[k], v, 1e-4, k)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


def _config(model="ico2ico_vae"):
    cfg = Config()
    cfg.model.name = model
    cfg.model.subdivisions, cfg.model.widths, cfg.model.latent_features = S, WIDTHS, LATENT
    cfg.train.batch_size = B
    cfg.train.log_grad_freq = 0
    # the default cyclic LR starts at 1e-9 and climbs 5e-7 a step: Adam moves
    # a parameter by about the LR whatever its gradient's size, so a
    # near-zero gradient whose sign differs between the packages moves it
    # either way, and the normal term turns a 1e-5 move into a 1e-3 change
    # of the next grad norm; at these LRs the steps stay comparable
    return cfg


def _run_both(cfg, variables, ds, seed, epoch=0, patches=()):
    """Both trainers over one shuffled epoch of ds: (JAX metrics, port metrics)."""
    ref = []
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        jt = JaxTrainer(cfg)
        state = jt.init_state(ds.inputs[:1])
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = state.replace(params=params, opt_state=jt.tx.init(params),
                              batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
        for idx, wt in JaxBatches(ds, B, shuffle=True, seed=seed).epoch_indices():
            state, m, _, _ = jt._jit_train_step(state, ds.inputs[idx], ds.targets[idx], wt,
                                                epoch)
            ref.append({k: float(v) for k, v in jax.device_get(m).items()})
        pt = Trainer(cfg, device="cpu")
        st = pt.init_state(variables)
        got = [{k: float(v) for k, v in pt.train_step(st, x, y, wt, epoch).items()}
               for x, y, wt in Batches(ds, B, shuffle=True, seed=seed, device="cpu").epoch()]
    assert set(got[0]) == set(ref[0])
    return ref, got, pt


def _check_steps(ref, got, keys):
    """Per-step metrics within 1e-5 and grad norms within 1e-4, relative.
    The seeds give no near-zero predicted vertex normal: where a random
    network at init makes one (about one batch in eight here), the normal
    term's gradient, through 1/|n|, reaches 1e6-1e8 and float32 rounding in
    either package moves it by tens of percent."""
    for g, r in zip(got, ref, strict=True):
        assert r["grad_norm"] < 100.0, r["grad_norm"]
        for k in keys:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=1e-4)
        assert g["finite"] == r["finite"] == 1.0


def test_vae_trainer_matches_jax_trainer():
    cfg = _config()
    ds = synthetic_dataset(S, 3 * B, seed=2)
    ref, got, pt = _run_both(cfg, _vae_variables(5), ds, seed=3, epoch=30,
                             patches=_fixed_eps(_eps()))
    assert len(got) == 3 and pt.model.pallas_blocks is None
    _check_steps(ref, got, ("total", "mse", "cos", "lap", "kld", "recon"))
    mu, logvar = pt.last_misc
    assert mu.shape == logvar.shape == (B, 5 * 2 ** (S - 3), 2 ** (S - 2), LATENT)


def test_vae_trainer_matches_jax_trainer_on_its_fused_route():
    """The JAX Trainer with ``use_pallas``, every Pallas call in interpret
    mode: at B=4 its VAE takes ``pallas_blocks=None`` (every block fused),
    so its head's backward is ``_phead_bwd``."""
    cfg = _config()
    cfg.model.use_pallas = True
    ds = synthetic_dataset(S, 2 * B, seed=6)
    patches = (*_fixed_eps(_eps(11)), mock.patch.object(jax, "default_backend", lambda: "tpu"),
               pltpu.force_tpu_interpret_mode())
    ref, got, _ = _run_both(cfg, _vae_variables(7), ds, seed=8, patches=patches)
    assert len(got) == 2
    _check_steps(ref, got, ("total", "mse", "cos", "lap", "kld"))


def test_ae_trainer_with_normal_and_laplacian_terms_matches_jax():
    """The AE's generic loss branch (the model's reconstruction, then
    ``p2p_loss``) against the JAX Trainer's, two steps."""
    cfg = _config("ico2ico")
    cfg.f_nor, cfg.f_lap = 0.2, 0.3
    ds = synthetic_dataset(S, 2 * B, seed=21)
    ref, got, pt = _run_both(cfg, bridge.init_variables(S, WIDTHS, seed=1), ds, seed=14)
    assert not pt.fused_mse and len(got) == 2
    _check_steps(ref, got, ("total", "mse", "cos", "lap"))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_app_state_serves_a_vae():
    from geniconet_tpu_torch.ops.vertices import grid_to_vertices

    cfg = _config()
    cfg.data.synthetic = 5
    variables = _vae_variables(3)
    st = AppState(device="cpu")
    info = st.load(cfg, variables=variables)
    assert info["is_vae"] and info["latent_shape"] == [5 * 2 ** (S - 3), 2 ** (S - 2), LATENT]
    ref_mu, ref_lv = _flax_vae().apply(variables, jnp.asarray(st.dataset.inputs),
                                       method="encode")
    assert st.latents.dtype == st.logvars.dtype == np.float32
    _close(st.latents, ref_mu, 1e-4, "latent cache")
    _close(st.logvars, ref_lv, 1e-4, "logvars")
    i, k, seed = 2, 1.5, 4
    z = st.latents[i] + k * np.exp(0.5 * st.logvars[i]) * np.random.RandomState(seed).randn(
        *st.latents[i].shape).astype(np.float32)
    with torch.no_grad():
        want = grid_to_vertices(st.model.decode(_t(z[None])), S)[0].numpy()
    np.testing.assert_array_equal(st.regenerate(i, k, seed), want)
    out = handle_api(st, "/api/regenerate", {"i": i, "k": k, "seed": seed, "coloring": "patch"})
    np.testing.assert_allclose(np.reshape(out["vertices"], (-1, 3)), want, atol=1e-5)

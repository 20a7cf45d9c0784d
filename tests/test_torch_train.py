"""The port's training path against the JAX package, on the CPU.

* The training-mode ``IcoAE`` under five routings (``pallas_blocks`` None,
  the JAX default with every block on the kernels' plain versions and custom
  VJPs, and four partial ones) against flax ``IcoAE(use_pallas=False)``
  applied with ``train=True, mutable=["batch_stats"]`` in float64, with the
  same weights through ``bridge.py``: loss, every gradient leaf and the new
  batch_stats within 1e-4·max|ref| (the port in float32). The fused route's
  math equals the XLA route's (tests/test_model_pallas_parity.py).
* Three steps of the port's default ``Trainer`` (every block fused) against
  the JAX ``Trainer`` on its XLA route (the CPU's), and two steps against
  the JAX ``Trainer`` on its fused route (Pallas interpret mode, the
  head+MSE loss), same config, data and batch order: losses within 1e-5
  relative and grad norms within 1e-4; after the three steps, batch_stats
  within 1e-4·max|ref|, parameters within twice the summed learning rates
  (Adam moves a parameter by about the LR per step, whatever the gradient's
  size, so a near-zero gradient whose sign differs costs up to that); and
  where JAX moved a parameter by more than half the summed LRs, ours moves
  it the same way (99% of them). The JAX float32 gradients carry up to
  2e-3·max|ref| of rounding noise here (see ``_flax_train_reference``), so
  the per-step losses and grad norms are the tight check.
* ``Batches`` shuffles as the JAX ``Batches``; the cyclic LR matches; the
  fused head trains without a target (through ``fused_pair_head`` and its
  backward, kernel e's plain version) with the plain head's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.data.pipeline import Batches as JaxBatches
from geniconet_tpu.nn.models import IcoAE as FlaxIcoAE
from geniconet_tpu.train.config import Config
from geniconet_tpu.train.schedule import cyclic_triangular as jax_cyclic
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.nn.models import IcoAE
from geniconet_tpu_torch.ops.vertices import pack_target_phases
from geniconet_tpu_torch.train.schedule import cyclic_triangular
from geniconet_tpu_torch.train.trainer import Trainer

S, WIDTHS, B = 3, (8, 16, 16), 4


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_leaves(got, ref, tol, atol=0.0):
    got, ref = _leaves(got), _leaves(ref)
    assert set(got) == set(ref)
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= tol * np.abs(ref[k]).max() + atol, (k, err, np.abs(ref[k]).max())


def _flax_train_reference(variables, x, tpack, tpoles, w):
    """Loss, gradients and new batch_stats of flax IcoAE(use_pallas=False)
    in train mode, in float64: flax's float32 gradients here differ from the
    float64 ones by up to 2e-3·max|ref| (the batch statistics' backward
    loses digits to cancellation, in another order than the port's), which
    would hide the port's own error."""
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        fm = FlaxIcoAE(subdivisions=S, widths=WIDTHS, use_pallas=False, dtype=jnp.float64)

        def loss(params):
            sse, upd = fm.apply(
                {"params": params, "batch_stats": jax.tree.map(f64, variables["batch_stats"])},
                f64(x), f64(tpack), f64(tpoles), train=True, method=FlaxIcoAE.recon_sse,
                mutable=["batch_stats"])
            return jnp.sum(sse * f64(w)), upd["batch_stats"]

        (value, stats), grads = jax.value_and_grad(loss, has_aux=True)(
            jax.tree.map(f64, variables["params"]))
        return float(value), *jax.tree.map(np.asarray, (grads, stats))


@pytest.mark.parametrize("blocks", [None, "conv_in,up0,up1,up2", "down1,up0,up1,up2",
                                    "up0,up1,up2,head", "up0,up1,up2"])
def test_training_model_matches_flax(blocks):
    variables = bridge.init_variables(S, WIDTHS, seed=4, random_stats=True)
    ds = synthetic_dataset(S, B, seed=1)
    x, y = ds.inputs, ds.targets
    w = np.random.RandomState(0).uniform(0.5, 1.5, B).astype(np.float32)
    tpack, tpoles = (np.asarray(a) for a in pack_target_phases(torch.from_numpy(y), S))
    ref_loss, ref_grads, ref_stats = _flax_train_reference(variables, x, tpack, tpoles, w)

    m = IcoAE(S, WIDTHS, pallas_blocks=blocks)
    m.load_state_dict(bridge.flax_to_state_dict(variables))
    sse = m.recon_sse(torch.from_numpy(x), *(torch.from_numpy(a) for a in (tpack, tpoles)),
                      train=True)
    loss = (sse * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    got = _leaves(bridge.state_dict_to_flax({k: p.grad for k, p in m.named_parameters()}))
    ref = _leaves({"params": ref_grads})
    assert set(got) == set(ref)
    for k in ref:
        # a conv's bias feeds a BatchNorm, so its exact gradient is 0 and
        # both sides hold rounding noise: hold it against its taps' scale
        scale = np.abs(ref[k.replace("['bias']", "['taps']") if "conv" in k else k]).max()
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * scale, k
    _close_leaves(bridge.state_dict_to_flax(m.state_dict())["batch_stats"], ref_stats, 1e-4)


def _config():
    cfg = Config()
    cfg.model.subdivisions, cfg.model.widths = S, WIDTHS
    cfg.train.batch_size = B
    cfg.optim.lr_base, cfg.optim.lr_max = 1e-5, 3e-4
    cfg.optim.step_size_up = cfg.optim.step_size_down = 20
    return cfg


def test_trainer_matches_jax_trainer():
    cfg = _config()
    ds = synthetic_dataset(S, 3 * B, seed=2)
    variables = bridge.init_variables(S, WIDTHS, seed=5)

    jt = JaxTrainer(cfg)
    state = jt.init_state(ds.inputs[:1])
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = state.replace(params=params, opt_state=jt.tx.init(params),
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    ref = []
    for idx, wt in JaxBatches(ds, B, shuffle=True, seed=3).epoch_indices():
        state, metrics, _, _ = jt._jit_train_step(state, ds.inputs[idx], ds.targets[idx], wt, 0)
        ref.append({k: float(v) for k, v in jax.device_get(metrics).items()})

    pt = Trainer(cfg, device="cpu")
    assert pt.model.pallas_blocks is None  # the JAX AE default: every block fused
    st = pt.init_state(variables)
    got = [{k: float(v) for k, v in pt.train_step(st, x, y, wt).items()}
           for x, y, wt in Batches(ds, B, shuffle=True, seed=3, device="cpu").epoch()]

    assert len(got) == len(ref) == 3 and st.step == 3
    lrs = []
    for g, r in zip(got, ref):
        for k in ("total", "mse"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5)
        np.testing.assert_allclose(g["lr"], r["lr"], rtol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=1e-4)
        assert g["finite"] == r["finite"] == 1.0
        lrs.append(r["lr"])
    ours = pt.variables()
    # the running statistics come from forwards at parameters that already
    # differ by up to the LR, so they are held to the tree's largest value
    ref_bs = jax.device_get(state.batch_stats)
    scale = max(np.abs(v).max() for v in _leaves(ref_bs).values())
    _close_leaves(ours["batch_stats"], ref_bs, 0.0, atol=1e-4 * scale)
    ref_p = jax.device_get(state.params)
    _close_leaves(ours["params"], ref_p, 0.0, atol=2 * sum(lrs))
    # the bound above would also pass a state that never moved: hold the
    # update itself, each element's change against JAX's, where JAX moved
    init = _leaves(variables["params"])
    d_ours, d_ref = (np.concatenate([(v - init[k]).ravel() for k, v in _leaves(t).items()])
                     for t in (ours["params"], ref_p))
    moved = np.abs(d_ref) > 0.5 * sum(lrs)
    assert moved.mean() > 0.5, moved.mean()
    agree = (np.sign(d_ours[moved]) == np.sign(d_ref[moved])).mean()
    assert agree >= 0.99, agree


def test_trainer_matches_jax_trainer_on_its_fused_route():
    """The JAX Trainer with ``use_pallas`` on its fused route, every Pallas
    call in interpret mode and the loss from ``fused_pair_head_mse``, as
    tests/test_round3.py runs it, against the port's default Trainer.

    The same config as ``test_trainer_matches_jax_trainer``: at B=8 and
    widths (8, 12, 16) both JAX float32 routes put the first step's grad
    norm 7.1e-4 (relative) off flax's float64 one, the port 6e-7, so a
    1e-4 bound there would measure JAX's float32 rounding, not the port."""
    import unittest.mock as mock

    from jax.experimental.pallas import tpu as pltpu

    cfg = _config()
    cfg.model.use_pallas, cfg.train.log_grad_freq = True, 0
    ds = synthetic_dataset(S, 2 * B, seed=6)
    variables = bridge.init_variables(S, WIDTHS, seed=7)
    bs = B
    ref = []
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        with pltpu.force_tpu_interpret_mode():
            jt = JaxTrainer(cfg)
            assert jt.model.use_pallas and jt._fused_mse
            state = jt.init_state(ds.inputs[:1])
            params = jax.tree.map(jnp.asarray, variables["params"])
            state = state.replace(params=params, opt_state=jt.tx.init(params),
                                  batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
            for idx, wt in JaxBatches(ds, bs, shuffle=True, seed=8).epoch_indices():
                state, m, _, _ = jt._jit_train_step(state, ds.inputs[idx], ds.targets[idx], wt, 0)
                ref.append({k: float(v) for k, v in jax.device_get(m).items()})
    pt = Trainer(cfg, device="cpu")
    st = pt.init_state(variables)
    got = [{k: float(v) for k, v in pt.train_step(st, x, y, wt).items()}
           for x, y, wt in Batches(ds, bs, shuffle=True, seed=8, device="cpu").epoch()]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["total"], r["total"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=1e-4)


def test_batches_shuffle_as_the_jax_batches():
    ds = synthetic_dataset(1, 10, seed=0)
    ours, ref = Batches(ds, 4, seed=7, device="cpu"), JaxBatches(ds, 4, shuffle=True, seed=7)
    for _ in range(2):
        for (a, wa), (b, wb) in zip(ours.epoch_indices(), ref.epoch_indices(), strict=True):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(wa, wb)
    x, y, wt = next(iter(Batches(ds, 4, seed=7, device="cpu").epoch()))
    idx = next(iter(Batches(ds, 4, seed=7, device="cpu").epoch_indices()))[0]
    np.testing.assert_array_equal(x.numpy(), ds.inputs[idx])
    np.testing.assert_array_equal(y.numpy(), ds.targets[idx])


def test_cyclic_lr_matches_jax():
    for step in (0, 1, 7, 19, 20, 21, 39, 40, 57):
        np.testing.assert_allclose(cyclic_triangular(step, 1e-9, 1e-3, 20, 20),
                                   float(jax_cyclic(step, 1e-9, 1e-3, 20, 20)), rtol=1e-7)


@pytest.mark.parametrize("blocks", [None, "up0,up1,up2,head"])
def test_fused_head_trains_without_a_target(blocks):
    """``decode(z, train=True)`` with the head on the kernel route (the
    VAE's loss path) against the same model with the head on the plain
    route: the reconstruction, the gradients of z and of every parameter,
    and the new batch statistics, within 1e-5·max|ref| (float32, only the
    order of the sums differs)."""
    plain_blocks = ",".join(b for b in ("conv_in", "down0", "down1", "down2", "up0", "up1", "up2")
                            if blocks is None or b in blocks)
    variables = bridge.init_variables(S, WIDTHS, seed=8, random_stats=True)
    r = np.random.RandomState(9)
    z0 = r.randn(2, 5 * 2 ** (S - 3), 2 ** (S - 2), WIDTHS[-1]).astype(np.float32)
    ct = torch.from_numpy(r.randn(2, 5 * 2**S, 2 ** (S + 1), 3).astype(np.float32))
    out = []
    for b in (blocks, plain_blocks):
        m = IcoAE(S, WIDTHS, pallas_blocks=b)
        m.load_state_dict(bridge.flax_to_state_dict(variables))
        z = torch.from_numpy(z0).requires_grad_()
        recon = m.decode(z, train=True)
        (recon * ct).sum().backward()
        out.append((recon.detach(), z.grad,
                    {k: p.grad for k, p in m.named_parameters() if k.startswith("decoder.")},
                    {k: v for k, v in m.state_dict().items() if k.endswith((".mean", ".var"))}))
    assert IcoAE(S, WIDTHS, pallas_blocks=blocks).decoder.fused_head
    assert not IcoAE(S, WIDTHS, pallas_blocks=plain_blocks).decoder.fused_head
    (recon, gz, grads, stats), (recon_r, gz_r, grads_r, stats_r) = out
    # a conv's bias feeds a BatchNorm: its exact gradient is 0, so it is
    # held against its taps' scale
    scales = {k: grads_r[k[: -len("bias")] + "taps" if ".conv" in k and k.endswith(".bias")
                         else k].abs().max() for k in grads_r}
    for got, ref, scale in [(recon, recon_r, recon_r.abs().max()), (gz, gz_r, gz_r.abs().max()),
                            *[(grads[k], grads_r[k], scales[k]) for k in grads_r],
                            *[(stats[k], stats_r[k], stats_r[k].abs().max()) for k in stats_r]]:
        assert (got - ref).abs().max() <= 1e-5 * scale
    assert grads["decoder.head.kernel"].abs().max() > 0


def test_position_loss_matches_jax():
    """``p2p_loss``'s position term, and the decoder's phase-sliced SSE that
    the trainer uses in its place, against the JAX ``p2p_loss``."""
    from geniconet_tpu.losses.p2p import LossFactors as JaxFactors
    from geniconet_tpu.losses.p2p import p2p_loss as jax_p2p
    from geniconet_tpu_torch.losses.p2p import LossFactors, p2p_loss
    from geniconet_tpu_torch.nn.models import _position_sse

    r = np.random.RandomState(3)
    grid = r.uniform(-1, 1, (3, 5 * 2**S, 2 ** (S + 1), 3)).astype(np.float32)
    target = synthetic_dataset(S, 3, seed=4).targets
    w = np.array([1.0, 0.5, 2.0], np.float32)
    ref, ref_m = jax_p2p(jnp.asarray(grid), jnp.asarray(target), S, JaxFactors.ae(),
                         jnp.asarray(w))
    got, got_m = p2p_loss(torch.from_numpy(grid), torch.from_numpy(target), S, LossFactors.ae(),
                          torch.from_numpy(w))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(got_m["mse"].item(), float(ref_m["mse"]), rtol=1e-6)
    sse = _position_sse(torch.from_numpy(grid).reshape(3, 5, 2**S, 2 ** (S + 1), 3),
                        *pack_target_phases(torch.from_numpy(target), S))
    per_sample = sse / ((10 * 4**S + 2) * 3.0)
    np.testing.assert_allclose((per_sample * torch.from_numpy(w)).sum().item() / w.sum(),
                               float(ref), rtol=1e-6)

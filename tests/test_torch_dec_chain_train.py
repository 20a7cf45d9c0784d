"""The ``Trainer`` on the decoder's phase chain (kernel n, ``phase_chain="dec"``
and ``"1"``) against the JAX ``Trainer`` on its own chain, on the CPU.

The JAX side reads ``GENICONET_EXPERIMENTAL``, ``GENICONET_PHASE_CHAIN``,
``GENICONET_KERNEL_GEFF`` and ``GENICONET_PALLAS_FOLD`` when it traces, so
each test sets them (``monkeypatch``) before it builds its Trainer; every
Pallas call runs in interpret mode. Two steps of ``Trainer(phase_chain="1")``,
AE and VAE (eps fixed by ``mock.patch`` of ``reparameterize`` in both
packages), and two AE steps of ``Trainer(phase_chain="dec",
kernel_geff="0")`` (every stats fold outside the kernels: JAX's Pallas fold
kernel, the port's kernel l): losses within 1e-5 and grad norms within 1e-4
relative, as the trainer tests of the default route. Spies assert that the
JAX chain's Pallas n kernels (and m's, and the fold kernel) ran, and that
the port went through ``up_pair_dx`` and ``up_pair_dtaps`` (and
``ds2s_dx``, ``stats_geff``). The VAE's case is in
``tests/test_torch_dec_chain_train_vae.py`` (each file about 75 s a case in
one process, so that ``--dist loadfile`` spreads them); the other
decoder-chain tests are in ``tests/test_torch_dec_chain.py``.
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
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu.train.config import Config
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.ops.kernels import fused
from geniconet_tpu_torch.train.trainer import Trainer


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


def dec_chain_trainer_matches_jax_trainer(env, model, chain, kernel_geff):
    """Two steps of ``Trainer(phase_chain=chain, kernel_geff=...)`` against
    the JAX Trainer with ``use_pallas`` under ``GENICONET_PHASE_CHAIN=chain``
    (every Pallas call in interpret mode). At s=3 up1 and up2 run kernel n;
    up0 takes the latent grid. With ``kernel_geff="0"`` both sides fold
    every stats cotangent before the kernels (JAX through its Pallas fold
    kernel, ``GENICONET_PALLAS_FOLD=1``)."""
    fold_outside = kernel_geff is not None
    env(PHASE_CHAIN=chain, KERNEL_GEFF=kernel_geff, PALLAS_FOLD="1" if fold_outside else None)
    vae = model == "ico2ico_vae"
    cfg = _config(model)
    ds = synthetic_dataset(S, 2 * B, seed=6)
    variables = bridge.init_variables(S, WIDTHS, seed=7, random_stats=vae, model=model,
                                      latent_features=LATENT)
    patches = [mock.patch.object(jax, "default_backend", lambda: "tpu"),
               pltpu.force_tpu_interpret_mode(), *(_fixed_eps(11) if vae else ())]
    # the JAX decoder chain's kernel bodies (n), m's with the encoder's, and
    # l's where the fold is outside
    watched_names = ["_up_pair_fwd_kernel", "_up_pair_dx_kernel", "_up_pair_dtaps_kernel",
                     *(["_ds2s_dx_kernel"] if chain == "1" else []),
                     *(["_fold_geff_kernel"] if fold_outside else [])]
    ref = []
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        watched = [stack.enter_context(mock.patch.object(jpk, n, wraps=getattr(jpk, n)))
                   for n in watched_names]
        jt = JaxTrainer(cfg)
        assert jt.model.use_pallas
        state = jt.init_state(ds.inputs[:1])
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = state.replace(params=params, opt_state=jt.tx.init(params),
                              batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
        for idx, wt in JaxBatches(ds, B, shuffle=True, seed=8).epoch_indices():
            state, m, _, _ = jt._jit_train_step(state, ds.inputs[idx], ds.targets[idx], wt, 0)
            ref.append({k: float(v) for k, v in jax.device_get(m).items()})
        assert all(w.called for w in watched), [n for n, w in zip(watched_names, watched)
                                                if not w.called]
        pt = Trainer(cfg, device="cpu", phase_chain=chain, kernel_geff=kernel_geff)
        st = pt.init_state(variables)
        names = ("up_pair_dx", "up_pair_dtaps", "ds2s_dx", "stats_geff")
        port_spies = dict(zip(names, (
            stack.enter_context(mock.patch.object(fused, n, wraps=getattr(fused, n)))
            for n in names)))
        got = [{k: float(v) for k, v in pt.train_step(st, x, y, wt).items()}
               for x, y, wt in Batches(ds, B, shuffle=True, seed=8, device="cpu").epoch()]
    # two steps: up1 and up2 each run n's dx and dtaps once a step
    assert port_spies["up_pair_dx"].call_count == port_spies["up_pair_dtaps"].call_count == 4
    assert port_spies["ds2s_dx"].called == (chain == "1")
    assert port_spies["stats_geff"].called == fold_outside
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for k in ("total", "mse", "kld") if vae else ("total", "mse"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=1e-4)
        assert g["finite"] == r["finite"] == 1.0


@pytest.mark.parametrize("chain, kernel_geff", [("1", None), ("dec", "0")])
def test_dec_chain_trainer_matches_jax_trainer_on_its_chain(env, chain, kernel_geff):
    dec_chain_trainer_matches_jax_trainer(env, "ico2ico", chain, kernel_geff)

"""The ``Trainer`` on the merged blocks (kernels o and p,
``merged_block="all"``) against the JAX ``Trainer`` on its own merged-block
route, on the CPU.

The JAX side reads ``GENICONET_EXPERIMENTAL`` and ``GENICONET_MERGED_BLOCK``
when it traces, so each test sets them (``monkeypatch``) before it builds
its Trainer; every Pallas call runs in interpret mode
(``GENICONET_PALLAS_INTERPRET``, as the JAX package's merged-block tests run
it). Two steps of ``Trainer(merged_block="all")``, AE and VAE (eps fixed by
``mock.patch`` of ``reparameterize`` in both packages): losses within 1e-5
and grad norms within 1e-4 relative, as the trainer tests of the default
route. Spies assert that the JAX block kernels (``_up_block_kernel``,
``_dn_block_kernel``) ran, and that the port went through ``up_block_fwd``
at every UpBlock and ``dn_block_fwd`` at every DownBlock. The other
merged-block tests are in ``tests/test_torch_merged_block.py``.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
def test_merged_block_trainer_matches_jax_trainer(monkeypatch, model):
    """Two steps of ``Trainer(merged_block="all")`` against the JAX Trainer
    with ``use_pallas`` under ``GENICONET_MERGED_BLOCK=all``. The AE's three
    UpBlocks run o and its three DownBlocks p; the VAE's encoder has two."""
    monkeypatch.setenv("GENICONET_EXPERIMENTAL", "1")
    monkeypatch.setenv("GENICONET_MERGED_BLOCK", "all")
    monkeypatch.setenv("GENICONET_PALLAS_INTERPRET", "1")
    vae = model == "ico2ico_vae"
    cfg = _config(model)
    ds = synthetic_dataset(S, 2 * B, seed=6)
    variables = bridge.init_variables(S, WIDTHS, seed=7, random_stats=vae, model=model,
                                      latent_features=LATENT)
    patches = [mock.patch.object(jax, "default_backend", lambda: "tpu"),
               *(_fixed_eps(11) if vae else ())]
    watched_names = ["_up_block_kernel", "_dn_block_kernel"]
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
        pt = Trainer(cfg, device="cpu", merged_block="all")
        st = pt.init_state(variables)
        o = stack.enter_context(mock.patch.object(fused, "up_block_fwd",
                                                  wraps=fused.up_block_fwd))
        p = stack.enter_context(mock.patch.object(fused, "dn_block_fwd",
                                                  wraps=fused.dn_block_fwd))
        got = [{k: float(v) for k, v in pt.train_step(st, x, y, wt).items()}
               for x, y, wt in Batches(ds, B, shuffle=True, seed=8, device="cpu").epoch()]
    assert o.call_count == 2 * 3 and p.call_count == 2 * (2 if vae else 3)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for k in ("total", "mse", "kld") if vae else ("total", "mse"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=1e-4)
        assert g["finite"] == r["finite"] == 1.0

"""The port's epoch loop, validation, command line and explorer loading, on the CPU.

* ``Trainer.fit`` of the AE against the JAX ``Trainer.fit`` from the same
  variables, batches and seeds, over 2 epochs whose training and
  validation sets both end in a ragged batch (s=3, widths (8, 16, 16),
  B=4): the validation history within 1e-5 relative, the same checkpoint
  file names (EB on ties too, E on ``save_epoch_freq`` and at the end), and
  the same ``best_loss`` in the last file.
* The VAE's ``fit`` saves ``misc`` with the last training batch's (mu,
  logvar); its validation equals the port's own eval loss under the eval
  generator (the JAX package draws its eval eps from its own PRNG), repeats,
  and leaves the training generator where it was.
* ``train_epoch``'s finite-loss guard raises ``FloatingPointError``.
* The command line in-process with ``--device cpu``: train 2 epochs, resume
  to 3 (the grad-flow norms under the JAX names, the parameter count
  JAX's), encode (``arr_0`` equal to ``AppState.latents``), sample a VAE
  (``.off`` files that ``read_off`` reads back, written and read as the JAX
  package's ``offio`` does); ``AppState.load(cfg, epoch=0)`` equals the
  load from the same variables; ``/api/load`` and ``/api/epochs`` answer;
  ``--process test`` and ``decode`` evaluate the trained files
  (``tests/test_torch_eval.py`` holds them against JAX). The routing comes
  from the JAX package's variables as its kernels read them.
"""

import copy
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.data import offio as jax_offio
from geniconet_tpu.data.pipeline import Batches as JaxBatches
from geniconet_tpu.ops.pallas import phase_kernel as jax_pk
from geniconet_tpu.train.config import Config
from geniconet_tpu.train.summary import count_params as jax_count_params
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu.train.trainer import TrainState as JaxTrainState
from geniconet_tpu_torch import bridge, cli
from geniconet_tpu_torch.app.server import handle_api
from geniconet_tpu_torch.app.state import AppState
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.offio import read_off
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.eval.test_driver import resolve_checkpoint
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.nn.layers import merged_block_enabled, phase_chain_enabled
from geniconet_tpu_torch.ops.kernels.fused import kernel_geff_enabled, merged_bwd_enabled
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.summary import count_params
from geniconet_tpu_torch.train.trainer import _EVAL_STREAM, Trainer

S, WIDTHS, B = 3, (8, 16, 16), 4


def _config(log_dir, model="ico2ico"):
    """s=3, narrow widths, B=4; LRs a tenth of ``test_trainer_matches_jax_trainer``'s
    (see ``test_fit_matches_the_jax_fit``)."""
    cfg = Config()
    cfg.model.name, cfg.model.subdivisions, cfg.model.widths = model, S, WIDTHS
    cfg.model.latent_features = 8
    cfg.train.batch_size, cfg.train.train_epoch, cfg.train.save_epoch_freq = B, 2, 1
    cfg.optim.lr_base, cfg.optim.lr_max = 1e-6, 3e-5
    cfg.optim.step_size_up = cfg.optim.step_size_down = 20
    cfg.log_dir = str(log_dir)
    return cfg


def _files(cfg):
    return sorted(os.listdir(os.path.join(cfg.model_log_dir(), "savedModel")))


def test_fit_matches_the_jax_fit(tmp_path):
    """The conv biases that feed a BatchNorm have an exact gradient of 0, so
    both packages hold float32 rounding noise there, which Adam turns into
    steps of up to the LR either way; eval mode (running statistics) sees
    them. So the LRs are small enough that 4 such steps stay under the
    history's 1e-5, and the port's eval of JAX's last checkpoint is held to
    JAX's last validation within 1e-6: the eval itself, without that drift."""
    trn_ds, val_ds = synthetic_dataset(S, 6, seed=3), synthetic_dataset(S, 6, seed=4)
    variables = bridge.init_variables(S, WIDTHS, seed=6)

    jcfg = _config(tmp_path / "jax")
    jt = JaxTrainer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(params=params, batch_stats=jax.tree.map(jnp.asarray,
                                                                  variables["batch_stats"]),
                          opt_state=jt.tx.init(params), step=jnp.zeros((), jnp.int32),
                          rng=jax.random.key(2))
    _, ref = jt.fit(state, JaxBatches(trn_ds, B, shuffle=True, seed=7, device_resident=False),
                    JaxBatches(val_ds, B, shuffle=False, device_resident=False))

    pcfg = copy.deepcopy(jcfg)
    pcfg.log_dir = str(tmp_path / "port")
    pt = Trainer(pcfg, device="cpu")
    st, got = pt.fit(pt.init_state(variables), Batches(trn_ds, B, seed=7, device="cpu"),
                     Batches(val_ds, B, shuffle=False, device="cpu"))
    assert len(got) == len(ref) == 2 and st.step == 4
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert _files(pcfg) == _files(jcfg)
    assert "ico2ico_E1.ckpt" in _files(pcfg) and "ico2ico_E2.ckpt" in _files(pcfg)
    last = [ckpt.load_checkpoint(os.path.join(c.model_log_dir(), "savedModel", "ico2ico_E2.ckpt"))
            for c in (pcfg, jcfg)]
    assert last[0]["best_loss"] == min(got)
    np.testing.assert_allclose(last[0]["best_loss"], last[1]["best_loss"], rtol=1e-5)
    assert (last[0]["epoch"], last[0]["step"]) == (last[1]["epoch"], last[1]["step"]) == (2, 4)
    at_jax = Trainer(pcfg, device="cpu")
    jst, _, _ = at_jax.restore(at_jax.init_state(variables),
                               os.path.join(jcfg.model_log_dir(), "savedModel", "ico2ico_E2.ckpt"))
    val = at_jax.validate(jst, Batches(val_ds, B, shuffle=False, device="cpu"), 1)
    np.testing.assert_allclose(val["total"], ref[-1], rtol=1e-6)


def test_vae_fit_saves_misc_and_validates_under_the_eval_generator(tmp_path):
    cfg = _config(tmp_path, "ico2ico_vae")
    cfg.train.train_epoch = 1
    trn_ds, val_ds = synthetic_dataset(S, 6, seed=3), synthetic_dataset(S, 5, seed=4)
    tr = Trainer(cfg, device="cpu")
    st = tr.init_state(bridge.init_variables(S, WIDTHS, seed=2, model=cfg.model.name,
                                             latent_features=8), seed=11)
    val = Batches(val_ds, B, shuffle=False, device="cpu")
    st, history = tr.fit(st, Batches(trn_ds, B, seed=1, device="cpu"), val)
    blob = ckpt.load_checkpoint(os.path.join(cfg.model_log_dir(), "savedModel",
                                             "ico2ico_vae_E1.ckpt"))
    hz, wz = 5 * 2 ** (S - 3), 2 ** (S - 2)
    assert blob["misc"]["trn_mean"].shape == blob["misc"]["trn_logvar"].shape == (2, hz, wz, 8)
    np.testing.assert_array_equal(blob["misc"]["trn_mean"], tr.last_misc[0].numpy())

    train_stream = tr.generator.get_state()
    gen = torch.Generator().manual_seed(11 + 2 + _EVAL_STREAM)
    sums, n = 0.0, 0.0
    with torch.no_grad():
        for x, y, wt in val.epoch():
            loss, _ = tr.loss(x, y, wt, train=False, epoch=0, generator=gen)
            sums, n = sums + float(loss) * float(wt.sum()), n + float(wt.sum())
    avg = tr.validate(st, val, 0)
    np.testing.assert_allclose(avg["total"], sums / n, rtol=1e-6)
    np.testing.assert_allclose(history[0], avg["total"], rtol=1e-6)
    assert tr.validate(st, val, 0) == avg
    assert set(avg) == {"total", "mse", "cos", "lap", "recon", "kld"}
    assert torch.equal(tr.generator.get_state(), train_stream)


def test_train_epoch_raises_on_a_non_finite_loss():
    cfg = _config("unused")
    cfg.train.log_freq = 1
    ds = synthetic_dataset(S, 4, seed=3)
    ds.inputs[1, 3, 5] = np.nan
    tr = Trainer(cfg, device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite loss at epoch 0 iter 0"):
        tr.train_epoch(tr.init_state(bridge.init_variables(S, WIDTHS)),
                       Batches(ds, B, device="cpu"), 0)


_FAMILIES = ("pcs1", "pcs1_front", "ds2", "upd", "std")


@pytest.mark.parametrize("env", [
    {}, {"GENICONET_MERGED_BWD": "all", "GENICONET_PHASE_CHAIN": "1"},
    {"GENICONET_EXPERIMENTAL": "1", "GENICONET_MERGED_BWD": "pcs1,upd",
     "GENICONET_PHASE_CHAIN": "enc", "GENICONET_MERGED_BLOCK": "up0,down1"},
    {"GENICONET_EXPERIMENTAL": "1", "GENICONET_PHASE_CHAIN": "dec",
     "GENICONET_KERNEL_GEFF": "std,ds2"},
    {"GENICONET_KERNEL_GEFF": "0"}, {"GENICONET_KERNEL_GEFF": ""},
    {"GENICONET_KERNEL_GEFF": "all"}, {"GENICONET_EXPERIMENTAL": "1",
                                       "GENICONET_KERNEL_GEFF": "!all"},
])
def test_cli_routing_reads_the_jax_variables(monkeypatch, env):
    for var in ("GENICONET_EXPERIMENTAL", "GENICONET_MERGED_BWD", "GENICONET_PHASE_CHAIN",
                "GENICONET_MERGED_BLOCK", "GENICONET_KERNEL_GEFF"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    r = cli.routing_from_env()
    for fam in _FAMILIES:
        assert merged_bwd_enabled(fam, r["merged_bwd"]) == jax_pk._merged_bwd_enabled(fam)
        if "GENICONET_KERNEL_GEFF" in env:  # unset: the port's own default folds every family
            assert kernel_geff_enabled(fam, r["kernel_geff"]) == jax_pk._kernel_geff_enabled(fam)
    assert r["kernel_geff"] is None or "GENICONET_KERNEL_GEFF" in env
    for part in ("enc", "dec"):
        assert phase_chain_enabled(part, r["phase_chain"]) == jax_pk.phase_chain_enabled(part)
    for block in ("up0", "up1", "down1", "down2"):
        assert merged_block_enabled(block, r["merged_block"]) == \
            jax_pk.merged_block_enabled(block)


def _argv(log_dir, model="ico2ico", *extra):
    return ["--model", model, "--device", "cpu", "--synthetic", "6", "--subdivision", str(S),
            "--widths", *map(str, WIDTHS), "--batch_size", str(B), "--latent_features", "8",
            "--logDir", str(log_dir), *extra]


def test_cli_trains_resumes_encodes_and_serves(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL only: fast
    ref = cli.main([*_argv(tmp_path), "--process", "train", "--train_epoch", "2"])
    cfg = cli.parse_args([*_argv(tmp_path), "--process", "encode"])
    assert len(ref) == 2 and "ico2ico_E2.ckpt" in _files(cfg)
    best = ckpt.latest_best_epoch(os.path.join(cfg.model_log_dir(), "savedModel"), "ico2ico")
    resumed = cli.main([*_argv(tmp_path), "--process", "train", "--train_epoch", "3",
                        "--load_pretrained_model"])
    out = capsys.readouterr().out
    assert f"resumed from {cfg.model_log_dir()}/savedModel/ico2ico_EB{best}.ckpt (epoch {best}" \
        in out
    assert len(resumed) == 3 - best and "ico2ico_E3.ckpt" in _files(cfg)
    with open(os.path.join(cfg.model_log_dir(), "config.json")) as f:
        assert json.load(f)["train"]["train_epoch"] == 3
    with open(os.path.join(cfg.model_log_dir(), "events.jsonl")) as f:
        prefixes = {json.loads(line).get("prefix") for line in f}
    assert {"trn", "val", "grad_flow"} <= prefixes
    with open(os.path.join(cfg.model_log_dir(), "events.jsonl")) as f:
        gflow = next(r for r in map(json.loads, f) if r.get("prefix") == "grad_flow")
    # the per-parameter grad norms under the JAX names (its trainer.py:482-490)
    params = bridge.init_variables(S, WIDTHS)["params"]
    names = {"/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(gflow) - {"t", "step", "prefix"} == names
    n = count_params(params)
    assert n == jax_count_params(params) == sum(p.numel() for p in Trainer(
        cfg, device="cpu").model.parameters())
    assert f"optimizable parameters: {n}" in out

    infos = cli.main([*_argv(tmp_path), "--process", "encode"])
    newest = ckpt.latest_best_epoch(os.path.join(cfg.model_log_dir(), "savedModel"), "ico2ico")
    assert [i["epoch"] for i in infos] == [newest, newest]
    st = AppState(device="cpu")
    info = st.load(cfg, "val", epoch=0)
    blob = ckpt.load_checkpoint(resolve_checkpoint(cfg))
    same = AppState(device="cpu")
    same.load(cfg, "val", variables={k: blob[k] for k in ("params", "batch_stats")})
    np.testing.assert_array_equal(st.latents, same.latents)
    np.testing.assert_array_equal(st.decode_latent(st.latents[1]),
                                  same.decode_latent(same.latents[1]))
    for k, name in enumerate(st.dataset.names):
        with np.load(os.path.join(cfg.model_log_dir(), "data", "enc", "val", name + ".npz")) as z:
            assert list(z) == ["arr_0"]
            np.testing.assert_array_equal(z["arr_0"], st.latents[k])
    assert info["epoch"] == newest

    body = {"model": "ico2ico", "subdivision": S, "widths": list(WIDTHS),
            "logDir": str(tmp_path), "synthetic": 6, "epoch": 3}
    served = AppState(device="cpu")
    info = handle_api(served, "/api/load", body)
    want = ckpt.available_epochs(os.path.join(cfg.model_log_dir(), "savedModel"), "ico2ico")
    assert info["epoch"] == 3 and info["epochs"] == want and 3 in want["periodic"]
    assert handle_api(served, "/api/epochs", {}) == want
    with pytest.raises(FileNotFoundError, match="available"):
        handle_api(AppState(device="cpu"), "/api/load", {**body, "epoch": 99})
    for process in ("test", "decode"):  # point2mesh: tests/test_torch_eval.py
        pairs, stats = cli.main([*_argv(tmp_path), "--process", process, "--test_mode",
                                 "point2point"])
        assert len(pairs) == 6 and np.isfinite(stats).all()


def test_cli_samples_a_vae(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cli.main([*_argv(tmp_path, "ico2ico_vae"), "--process", "train", "--train_epoch", "1"])
    out = cli.main([*_argv(tmp_path, "ico2ico_vae"), "--process", "sample", "--n_samples", "3",
                    "--test_epoch", "1"])
    files = sorted(os.listdir(out))
    assert files == [f"sample_{k:03d}.off" for k in range(3)]
    faces = ico.get_ico_faces(S)
    for f in files:
        v, fc = read_off(os.path.join(out, f))
        assert v.shape == (ico.num_vertices(S), 3) and np.isfinite(v).all()
        np.testing.assert_array_equal(fc, faces)
        for got, want in zip((v, fc), jax_offio.read_off(os.path.join(out, f)), strict=True):
            np.testing.assert_array_equal(got, want)
    jax_offio.write_off(str(tmp_path / "jax.off"), v, faces)
    assert (tmp_path / "jax.off").read_text() == Path(out, files[-1]).read_text()
    cli.main([*_argv(tmp_path), "--process", "train", "--train_epoch", "1"])
    with pytest.raises(SystemExit, match="misc"):  # an AE has no latent distribution
        cli.main([*_argv(tmp_path), "--process", "sample"])

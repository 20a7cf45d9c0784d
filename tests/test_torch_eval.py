"""The port's evaluation (``eval/test_driver.py``, ``--process test`` and
``decode``) and its train-start summaries, on the CPU, against the JAX package.

* The port's CLI trains an AE for 2 epochs (s=3, widths 8/12/16, 12
  synthetic meshes), then runs test (``--write_output_mesh``), encode and
  decode, as ``tests/test_cli.py`` drives the JAX CLI: the CSVs hold a
  ``Name,Distance`` header and one row a mesh, the meshes and encodings
  are written, and ``decode(encode(x))`` gives ``test``'s per-mesh
  point2point distances within 1e-5 (the JAX test's bound). The same for
  a VAE, which decodes mu. ``--test_mode none`` gives no metric, and
  decode without reference meshes writes the meshes only.
* The JAX package's ``run_test`` on the port's checkpoint gives the port's
  per-mesh point2mesh distances within rtol 1e-4 plus 1e-6 x the meshes'
  extent squared; the port's do not depend on the batch (a ragged last
  batch of 2, or one batch of 12).
* ``model_summary`` and ``model_graph_dot`` equal the JAX package's texts
  byte for byte (AE and VAE), and train start writes them.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geniconet_tpu.data.datasets import synthetic_dataset as jax_synthetic_dataset
from geniconet_tpu.eval.test_driver import run_test as jax_run_test
from geniconet_tpu.nn.models import IcoAE as JaxIcoAE
from geniconet_tpu.nn.models import IcoVAE as JaxIcoVAE
from geniconet_tpu.train.config import parse_args as jax_parse_args
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu.train.trainer import TrainState as JaxTrainState
from geniconet_tpu.train.summary import model_graph_dot as jax_model_graph_dot
from geniconet_tpu.train.summary import model_summary as jax_model_summary
from geniconet_tpu_torch import bridge, cli
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.eval.test_driver import run_decode, run_test
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.train.config import parse_args
from geniconet_tpu_torch.train.summary import model_graph_dot, model_summary

S, WIDTHS, N = 3, (8, 12, 16), 12


def _argv(log_dir, model="ico2ico"):
    return ["--model", model, "--subdivision", str(S), "--batch_size", "5", "--synthetic",
            str(N), "--logDir", str(log_dir), "--widths", *map(str, WIDTHS),
            "--latent_features", "8"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The log directory of an AE the port's CLI trained for 2 epochs."""
    log_dir = tmp_path_factory.mktemp("eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL only: fast
        cli.main([*_argv(log_dir), "--device", "cpu", "--process", "train", "--train_epoch", "2"])
    return log_dir


def _rows(path):
    with open(path) as f:
        rows = f.read().strip().splitlines()
    assert rows[0] == "Name,Distance"
    return {name: float(d) for name, d in (r.split(",") for r in rows[1:])}


def test_cli_tests_encodes_and_decodes(trained):
    argv = [*_argv(trained), "--device", "cpu"]
    ae = os.path.join(trained, "ae")
    pairs, stats = cli.main([*argv, "--process", "test", "--write_output_mesh"])
    rows = _rows(os.path.join(ae, "ico2ico_point2mesh.csv"))
    assert len(rows) == N and all(np.isfinite(list(rows.values())))
    assert rows == {n: float(f"{d:f}") for n, d in pairs}
    assert stats[0] == pytest.approx(np.mean([d for _, d in pairs]))
    assert sorted(os.listdir(os.path.join(ae, "data", "test"))) == sorted(
        f"synth_{k}.off" for k in range(N))

    cli.main([*argv, "--process", "encode"])
    enc = os.path.join(ae, "data", "enc", "trn")
    assert len(os.listdir(enc)) == N
    with np.load(os.path.join(enc, "synth_0.npz")) as z:
        assert z["arr_0"].shape == (5, 2, 16)  # the s=3 AE latent at widths 8 12 16

    cli.main([*argv, "--process", "decode"])
    assert len(_rows(os.path.join(ae, "ico2ico_decode_point2mesh.csv"))) == N
    assert os.path.exists(os.path.join(ae, "data", "dec", "synth_0.off"))

    # --test_mode none: no metric, no CSV; decode without reference meshes
    pairs, stats = cli.main([*argv, "--process", "test", "--test_mode", "none"])
    assert stats is None and len(pairs) == N and np.isnan([d for _, d in pairs]).all()
    assert not os.path.exists(os.path.join(ae, "ico2ico_none.csv"))
    cfg = parse_args([*argv, "--process", "decode", "--outDir", str(trained / "plain")])
    cfg.enc_dir = os.path.join(ae, "data", "enc", "val")
    pairs, stats = run_decode(cfg)
    assert stats is None and np.isnan([d for _, d in pairs]).all()
    assert len(os.listdir(trained / "plain" / "dec")) == N

    # decode(encode(x)) reproduces the model's reconstruction: the latents
    # through the files and the direct forward, on the same meshes
    cfg = parse_args([*argv, "--process", "decode"])
    cfg.test_mode = "point2point"
    ds = synthetic_dataset(S, N, seed=0)
    full = dict(run_test(cfg, ds, write_meshes=False)[0])
    dec = run_decode(cfg, ds, write_meshes=False)[0]
    assert [n for n, _ in dec] == ds.names
    for name, d in dec:
        assert abs(d - full[name]) < 1e-5, (name, d, full[name])


def _template_state(self, sample_input, seed=0):
    """The JAX ``init_state``'s TrainState from seeded variables, without
    the flax init's compile: ``restore`` then replaces every leaf."""
    fresh = jax.tree.map(jnp.asarray, bridge.init_variables(S, WIDTHS, seed=seed))
    return JaxTrainState(params=fresh["params"], batch_stats=fresh["batch_stats"],
                         opt_state=self.tx.init(fresh["params"]), step=jnp.zeros((), jnp.int32),
                         rng=jax.random.key(seed + 2))


def test_jax_run_test_on_the_port_checkpoint(trained, monkeypatch):
    """JAX's evaluation of the port's file against the port's own, and the
    port's at two batchings."""
    monkeypatch.setattr(JaxTrainer, "init_state", _template_state)
    ds = synthetic_dataset(S, N, seed=1)
    cfg = parse_args([*_argv(trained), "--device", "cpu", "--process", "test"])
    got = run_test(cfg, ds, write_meshes=False)[0]
    cfg.train.batch_size = N
    assert run_test(cfg, ds, write_meshes=False)[0] == pytest.approx(got, rel=1e-6, abs=1e-9)
    jcfg = jax_parse_args([*_argv(trained), "--no_data_parallel", "--process", "test"])
    ref = jax_run_test(jcfg, jax_synthetic_dataset(S, N, seed=1), write_meshes=False)[0]
    assert [n for n, _ in got] == [n for n, _ in ref] == ds.names
    extent = float(np.abs(ds.targets[..., :3]).max()) ** 2
    np.testing.assert_allclose([d for _, d in got], [d for _, d in ref], rtol=1e-4,
                               atol=1e-6 * extent)


def test_vae_decodes_mu(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = [*_argv(tmp_path, "ico2ico_vae"), "--device", "cpu"]
    cli.main([*argv, "--process", "train", "--train_epoch", "1"])
    cli.main([*argv, "--process", "encode"])
    cfg = parse_args([*argv, "--process", "decode", "--test_mode", "point2point"])
    ds = synthetic_dataset(S, N, seed=0)
    full = dict(run_test(cfg, ds, write_meshes=False)[0])
    dec = cli.main([*argv, "--process", "decode", "--test_mode", "point2point"])[0]
    assert len(dec) == N
    for name, d in dec:
        assert abs(d - full[name]) < 1e-5, (name, d, full[name])


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_summary_and_graph_are_the_jax_texts(model, trained):
    vae = model.endswith("vae")
    flax_model = (JaxIcoVAE(subdivisions=S, widths=WIDTHS, latent_features=8) if vae
                  else JaxIcoAE(subdivisions=S, widths=WIDTHS))
    rngs = {"params": jax.random.key(0), **({"reparam": jax.random.key(1)} if vae else {})}
    x = np.zeros((1, *ico.grid_shape(S), 3), np.float32)
    variables = bridge.init_variables(S, WIDTHS, model=model, latent_features=8)
    summ = model_summary(variables)
    dot = model_graph_dot(variables, type(flax_model).__name__, x.shape)
    assert summ == jax_model_summary(flax_model, jnp.asarray(x), rngs)
    assert dot == jax_model_graph_dot(flax_model, x, rngs)
    if not vae:  # what the CLI's train start wrote
        for name, text in (("summary.txt", summ), ("graph.dot", dot)):
            with open(os.path.join(trained, "ae", f"train_ico2ico_{name}")) as f:
                assert f.read() == text

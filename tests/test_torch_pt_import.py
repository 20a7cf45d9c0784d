"""The port's ``.pt`` import (``train/pt_import.py``, ``--load_pt``) against
the JAX package's, on the CPU.

* A reference-shaped state dict (AE and VAE, the reference's widths, masked
  3x3 OIHW conv weights, BatchNorm buffers, an index buffer to skip),
  written by ``torch.save``, imports into the same params and batch_stats
  trees in both packages, bit for bit, with the same epoch, loss, misc and
  skipped keys; the port reads it with ``torch.load(weights_only=True)``,
  which refuses a file that pickles a callable. ``--load_pt`` keeps the
  VAE's (mu, logvar) ``misc``.
* A non-zero corner tap is refused by both; a ``module.``-prefixed file
  maps nothing and is refused.
* ``--load_pt`` followed by ``--process test`` runs through the port's CLI
  (s=3, the reference's widths) and writes an EB file that the JAX
  ``Trainer`` restores to the imported weights, with fresh Adam moments;
  a widths mismatch is refused before anything is written.
"""

import collections
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.train import pt_import as jax_pt
from geniconet_tpu.train.config import Config as JaxConfig
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu.train.trainer import TrainState as JaxTrainState
from geniconet_tpu_torch import bridge, cli
from geniconet_tpu_torch.bridge import flatten_tree
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train import pt_import
from geniconet_tpu_torch.train.config import parse_args

S = 3
RNG = np.random.RandomState(7)


def _t(shape, scale=0.05, offset=0.0):
    return torch.from_numpy((offset + scale * RNG.standard_normal(shape)).astype(np.float32))


def _conv(prefix, cin, cout, sd):
    w = _t((cout, cin, 3, 3))
    w[:, :, 0, 0] = 0.0  # hex stencil: no (-1,-1) / (+1,+1) corners
    w[:, :, 2, 2] = 0.0
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = w, _t(cout)


def _bn(prefix, c, sd):
    sd[f"{prefix}.weight"] = _t(c, 0.1, 1.0)
    sd[f"{prefix}.bias"] = _t(c, 0.1)
    sd[f"{prefix}.running_mean"] = _t(c, 0.1)
    sd[f"{prefix}.running_var"] = _t(c, 0.1, 1.0) ** 2
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(123)


def _block(prefix, cin, cout, sd):
    # the reference's BasicIcoS2SDown/UpBlock internals (models.py:22-63)
    _conv(f"{prefix}.conv00", cin, cout, sd)
    _bn(f"{prefix}.icobn00", cout, sd)
    _conv(f"{prefix}.conv01", cout, cout, sd)
    _bn(f"{prefix}.icobn01", cout, sd)
    _conv(f"{prefix}.conv10", cin, cout, sd)
    _bn(f"{prefix}.icobn10", cout, sd)


def _state_dict(model):
    sd = collections.OrderedDict()
    _conv("encoder.0", 3, 64, sd)
    _bn("encoder.1", 64, sd)
    _block("encoder.3", 64, 128, sd)
    _block("encoder.4", 128, 256, sd)
    if model == "ico2ico":
        _block("encoder.5", 256, 256, sd)
        latent, head = 256, "enc2icoConv.0"
    else:
        for h in ("mu", "logvar"):
            _conv(f"{h}.0", 256, 512, sd)
            _bn(f"{h}.1", 512, sd)
        latent, head = 512, "final_layer.0"
    _block("decoder.0", latent, 256, sd)
    _block("decoder.1", 256, 128, sd)
    _block("decoder.2", 128, 64, sd)
    sd[f"{head}.weight"], sd[f"{head}.bias"] = _t((3, 64, 1, 1)), _t(3)
    sd["encoder.0.pad_index"] = torch.arange(10, dtype=torch.int64)  # an icocnn buffer
    return sd


def _save(path, sd, misc=None):
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "epoch": 696,
                "loss": 0.01234, "misc": misc}, path)
    return str(path)


def _assert_same_tree(a, b):
    fa, fb = dict(flatten_tree(a)), dict(flatten_tree(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=str(k))
        assert np.asarray(fa[k]).dtype == np.float32


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_import_gives_the_jax_trees(tmp_path, model):
    misc = [{"trn_mean": _t((2, 5, 2, 512)), "trn_logvar": _t((2, 5, 2, 512))}]
    path = _save(tmp_path / "ref.pt", _state_dict(model), misc if model.endswith("vae") else None)
    got = pt_import.load_reference_checkpoint(path, model)
    ref = jax_pt.load_reference_checkpoint(path, model)
    for col in ("params", "batch_stats"):
        _assert_same_tree(got[col], ref[col])
    assert (got["epoch"], got["loss"]) == (ref["epoch"], ref["loss"]) == (696, 0.01234)
    assert sorted(got["skipped_keys"]) == sorted(ref["skipped_keys"])
    assert "encoder.0.pad_index" in got["skipped_keys"]
    if model.endswith("vae"):
        for k in ("trn_mean", "trn_logvar"):
            np.testing.assert_array_equal(got["misc"][0][k], ref["misc"][0][k])
        # --load_pt keeps the (mu, logvar) misc that --process sample draws from
        cfg = parse_args(["--model", model, "--device", "cpu", "--subdivision", str(S),
                          "--logDir", str(tmp_path / "log"), "--load_pt", path,
                          "--process", "sample"])
        blob = ckpt.load_checkpoint(cli.import_pt_checkpoint(cfg))
        for k in ("trn_mean", "trn_logvar"):
            np.testing.assert_array_equal(blob["misc"][k], misc[0][k].numpy())
    else:
        assert got["misc"] is ref["misc"] is None


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def test_refusals(tmp_path):
    sd = _state_dict("ico2ico")
    sd["encoder.0.weight"][0, 0, 0, 0] = 0.5
    path = _save(tmp_path / "corner.pt", sd)
    for load in (pt_import.load_reference_checkpoint, jax_pt.load_reference_checkpoint):
        with pytest.raises(ValueError, match="corner"):
            load(path, "ico2ico")
    prefixed = {"module." + k: v for k, v in _state_dict("ico2ico").items()}
    with pytest.raises(ValueError, match="prefix"):
        pt_import.load_reference_checkpoint(_save(tmp_path / "dp.pt", prefixed), "ico2ico")
    evil = tmp_path / "evil.pt"
    torch.save({"model_state_dict": {}, "x": _Evil()}, evil)
    with pytest.raises(pickle.UnpicklingError):
        pt_import.load_reference_checkpoint(str(evil), "ico2ico")


def test_load_pt_then_test_through_the_cli(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path = _save(tmp_path / "ico2ico_EB696.pt", _state_dict("ico2ico"))
    argv = ["--model", "ico2ico", "--device", "cpu", "--synthetic", "3", "--subdivision", str(S),
            "--batch_size", "2", "--logDir", str(tmp_path / "log"), "--load_pt", path]
    with pytest.raises(ValueError, match="do not fit"):
        cli.main([*argv, "--widths", "64", "128", "128", "--process", "test"])
    assert not os.path.exists(tmp_path / "log" / "ae" / "savedModel")
    pairs, stats = cli.main([*argv, "--process", "test"])
    assert [n for n, _ in pairs] == ["synth_0", "synth_1", "synth_2"]
    assert all(np.isfinite(d) for _, d in pairs) and np.isfinite(stats).all()
    written = tmp_path / "log" / "ae" / "savedModel" / "ico2ico_EB696.ckpt"
    blob = ckpt.load_checkpoint(str(written))
    assert (blob["epoch"], blob["step"]) == (696, 0)
    assert blob["loss"] == blob["best_loss"] == pytest.approx(0.01234)

    # the JAX Trainer restores the file: the imported weights, zero moments
    # (its template state as init_state makes it, without the model's init)
    cfg = JaxConfig()
    cfg.model.subdivisions = S
    jt = JaxTrainer(cfg)
    fresh = jax.tree.map(jnp.asarray, bridge.init_variables(S, seed=9))
    template = JaxTrainState(params=fresh["params"], batch_stats=fresh["batch_stats"],
                             opt_state=jt.tx.init(fresh["params"]),
                             step=jnp.zeros((), jnp.int32), rng=jax.random.key(2))
    state, epoch, best = jt.restore(template, str(written))
    assert epoch == 696 and best == pytest.approx(0.01234)
    imported = pt_import.load_reference_checkpoint(path, "ico2ico")
    _assert_same_tree(jax.device_get(state.params), imported["params"])
    _assert_same_tree(jax.device_get(state.batch_stats), imported["batch_stats"])
    for _, leaf in flatten_tree(jax.device_get(state.opt_state[0].mu)):
        assert not np.asarray(leaf).any()

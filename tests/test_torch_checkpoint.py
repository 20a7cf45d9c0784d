"""The port's checkpoints against the JAX package's, on the CPU.

* The codec: the port's writer gives flax's ``msgpack_serialize`` bytes for
  the same tree, flax's ``msgpack_restore`` reads them back to the tree, and
  the port's reader turns flax's bytes into flax's tree (float32, int32 and
  bool arrays, numpy scalars, python ints of every width, floats, str,
  bytes, None, nested dicts, lists, the VAE's ``misc``); a bf16 array
  reads widened to float32 exactly; an orbax directory and flax's chunked
  form raise.
* The file rules: ``checkpoint_path``, ``available_epochs``,
  ``latest_best_epoch``, ``latest_checkpoint`` and ``gc_best_checkpoints``
  give the JAX module's answers on the same directory listings;
  ``restore_filtered`` and ``merge_checkpoints`` count the same matches.
* Resume across the packages, both ways, at s=3, widths (8, 16, 16), B=4:
  the JAX ``Trainer`` takes 2 steps and saves, the port's ``restore`` reads
  the file, its Adam moments equal JAX's ``mu``/``nu`` bit for bit, and a
  third step on both sides agrees (total and mse within 1e-5 relative,
  the grad norm within 1e-4: the bounds of ``test_trainer_matches_jax_trainer``);
  the port takes 2 steps and saves, the JAX ``Trainer.restore`` accepts the
  file into its own state tree, and every leaf equals the port's bit for bit.
"""

import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.data.pipeline import Batches as JaxBatches
from geniconet_tpu.train import checkpoint as jax_ckpt
from geniconet_tpu.train.config import Config
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu.train.trainer import TrainState as JaxTrainState
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.bridge import adam_state_to_flax
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.trainer import Trainer

S, WIDTHS, B = 3, (8, 16, 16), 4


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_tree(got, ref):
    """Same keys, and each leaf of the same type (array dtype) and value."""
    got, ref = _leaves(got), _leaves(ref)
    assert list(got) == list(ref)
    for k in ref:
        a, b = got[k], ref[k]
        assert type(a) is type(b), (k, type(a), type(b))
        if isinstance(b, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b or (a != a and b != b), (k, a, b)


def _trees():
    r = np.random.RandomState(0)
    return {
        "checkpoint": {
            "params": {"encoder": {"conv_in": {"taps": r.randn(7, 3, 8).astype(np.float32),
                                               "bias": np.zeros(8, np.float32)}}},
            "batch_stats": {"bn": {"BatchNorm_0": {"mean": r.randn(8).astype(np.float32)}}},
            "opt_state": {"0": {"count": np.asarray(2, np.int32),
                                "mu": {"w": r.randn(3, 5).astype(np.float32)}},
                          "1": {"count": np.asarray(2, np.int32)}},
            "step": 2, "epoch": 7, "loss": 0.125, "best_loss": float("inf"),
            "misc": {"trn_mean": r.randn(3, 5, 2, 4).astype(np.float32),
                     "trn_logvar": r.randn(3, 5, 2, 4).astype(np.float32)},
        },
        "scalars": {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 + 5, -1, -32,
                             -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63],
                    "floats": [0.0, -1.5, 1e300, float("-inf")], "none": None, "t": True,
                    "f": False, "str": "x" * 31, "str32": "y" * 40, "long_str": "z" * 300,
                    "utf8": "ébène", "bytes": b"\x00\x01" * 200, "np_f32": np.float32(1.5),
                    "np_i64": np.int64(-7), "np_bool": np.bool_(True)},
        "arrays": {"i32": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
                   "f64": np.linspace(0, 1, 5), "bool": np.array([True, False, True]),
                   "u8": np.arange(300, dtype=np.uint8).reshape(-1)[:255], "zero_d":
                   np.asarray(3.0, np.float32), "empty": np.zeros((0, 4), np.float32),
                   "big": r.randn(70000).astype(np.float32), "fixext16": np.zeros(0, np.int8)},
        "sizes": {str(i): list(range(i)) for i in (0, 15, 16, 70000)},
        "wide_map": {f"k{i}": i for i in range(17)},
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_codec_writes_and_reads_flax_msgpack(name):
    tree = _trees()[name]
    ours, theirs = ckpt.serialize(tree), fs.msgpack_serialize(tree)
    assert ours == theirs
    _assert_same_tree(fs.msgpack_restore(ours), fs.msgpack_restore(theirs))
    _assert_same_tree(ckpt.deserialize(theirs), fs.msgpack_restore(theirs))


def test_codec_reads_bf16_widened_and_refuses_what_it_cannot_read(tmp_path):
    x = jnp.asarray(np.random.RandomState(1).randn(4, 6), jnp.bfloat16)
    got = ckpt.deserialize(fs.msgpack_serialize({"x": x}))["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))
    chunked = fs.msgpack_serialize({"p": {"__msgpack_chunked_array__": True, "shape": {"0": 1},
                                          "chunks": {"0": np.zeros(1, np.float32)}}})
    with pytest.raises(ValueError, match="chunked"):
        ckpt.deserialize(chunked)
    orbax = tmp_path / "ico2ico_E1.ckpt"
    orbax.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_checkpoint(str(orbax))
    with pytest.raises(ValueError, match="truncated"):
        ckpt.deserialize(fs.msgpack_serialize({"a": np.zeros(8, np.float32)})[:-3])
    with pytest.raises(TypeError):
        ckpt.serialize({"t": object()})


LISTINGS = {
    "empty": [],
    "mixed": ["ico2ico_EB1.ckpt", "ico2ico_EB3.ckpt", "ico2ico_E2.ckpt", "ico2ico_E10.ckpt",
              "ico2ico_vae_EB12.ckpt", "ico2ico_vae_E14.ckpt", "ico2ico_EB3.ckpt.tmp",
              "ico2ico_EBx.ckpt", "xico2ico_EB9.ckpt", "config.json"],
    "equal epoch": ["ico2ico_EB5.ckpt", "ico2ico_E5.ckpt", "ico2ico_E4.ckpt"],
    "gc": [f"ico2ico_EB{e}.ckpt" for e in (1, 2, 3, 5, 8, 13, 21, 34, 55)]
          + ["ico2ico_E60.ckpt", "ico2ico_vae_EB1.ckpt", "ico2ico_vae_EB2.ckpt"],
    "vae only": [f"ico2ico_vae_EB{e}.ckpt" for e in range(1, 9)] + ["ico2ico_vae_E9.ckpt"],
}


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
@pytest.mark.parametrize("listing", list(LISTINGS))
def test_file_rules_give_the_jax_answers(tmp_path, listing, model):
    dirs = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        for f in LISTINGS[listing]:
            (d / f).write_bytes(b"")
        dirs[side] = str(d)
    port, ref = dirs["port"], dirs["jax"]
    assert ckpt.checkpoint_path(port, model, 7, True) == jax_ckpt.checkpoint_path(port, model, 7,
                                                                                   True)
    assert ckpt.checkpoint_path(port, model, 7, False) == jax_ckpt.checkpoint_path(port, model,
                                                                                    7, False)
    assert ckpt.available_epochs(port, model) == jax_ckpt.available_epochs(ref, model)
    assert ckpt.latest_best_epoch(port, model) == jax_ckpt.latest_best_epoch(ref, model)
    got, want = ckpt.latest_checkpoint(port, model), jax_ckpt.latest_checkpoint(ref, model)
    assert (got and os.path.basename(got)) == (want and os.path.basename(want))
    ckpt.gc_best_checkpoints(port, model)
    jax_ckpt.gc_best_checkpoints(ref, model)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    missing = str(tmp_path / "none")
    assert ckpt.available_epochs(missing, model) == jax_ckpt.available_epochs(missing, model)
    assert ckpt.latest_best_epoch(missing, model) is None
    assert ckpt.latest_checkpoint(missing, model) is None


def test_partial_loads_count_the_jax_matches(tmp_path):
    r = np.random.RandomState(2)
    target = {"encoder": {"a": np.zeros((3, 4), np.float32), "b": np.zeros(4, np.float32)},
              "decoder": {"c": np.zeros((2, 2), np.float32), "d": np.zeros(5, np.float32)}}
    enc = {"params": {"encoder": {"a": r.randn(3, 4).astype(np.float32),
                                  "b": r.randn(7).astype(np.float32)}}}  # b: wrong shape
    dec = {"params": {"decoder": {"c": r.randn(2, 2), "d": r.randn(5).astype(np.float32)},
                      "encoder": {"a": r.randn(3, 4).astype(np.float32)}}}
    got = ckpt.restore_filtered(target, enc["params"])
    ref = jax_ckpt.restore_filtered(target, enc["params"])
    assert got[1:] == ref[1:] == (1, 4)
    _assert_same_tree(got[0], jax.tree.map(np.asarray, ref[0]))
    paths = []
    for k, blob in enumerate((enc, dec)):
        paths.append(str(tmp_path / f"half{k}.ckpt"))
        jax_ckpt.save_checkpoint(paths[-1], blob)
    got = ckpt.merge_checkpoints(target, paths)
    ref = jax_ckpt.merge_checkpoints(target, paths)
    assert got[1:] == ref[1:] == (4, 4)
    _assert_same_tree(got[0], jax.tree.map(np.asarray, ref[0]))
    assert got[0]["decoder"]["c"].dtype == np.float32  # cast to the target's dtype


# ----------------------------------------------------------------------
# resume across the packages
# ----------------------------------------------------------------------


def _config():
    cfg = Config()
    cfg.model.subdivisions, cfg.model.widths = S, WIDTHS
    cfg.train.batch_size = B
    cfg.optim.lr_base, cfg.optim.lr_max = 1e-5, 3e-4
    cfg.optim.step_size_up = cfg.optim.step_size_down = 20
    return cfg


def _jax_state(jt, variables):
    """The JAX TrainState of ``variables`` (``init_state``'s, without its
    model init)."""
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JaxTrainState(params=params, batch_stats=jax.tree.map(jnp.asarray,
                                                                 variables["batch_stats"]),
                         opt_state=jt.tx.init(params), step=jnp.zeros((), jnp.int32),
                         rng=jax.random.key(2))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Trainer from seeded variables: 3 batches, its state after 2
    steps, and the metrics of the third."""
    cfg = _config()
    ds = synthetic_dataset(S, 3 * B, seed=2)
    variables = bridge.init_variables(S, WIDTHS, seed=5)
    batches = [idx for idx, _ in JaxBatches(ds, B, shuffle=True, seed=3).epoch_indices()]
    jt = JaxTrainer(cfg)
    state = _jax_state(jt, variables)
    wt = np.ones(B, np.float32)
    for idx in batches[:2]:
        state, _, _, _ = jt._jit_train_step(state, ds.inputs[idx], ds.targets[idx], wt, 0)
    saved = jax.device_get(state)
    _, third, _, _ = jt._jit_train_step(state, ds.inputs[batches[2]], ds.targets[batches[2]],
                                        wt, 0)
    return cfg, ds, variables, batches, jt, saved, {k: float(v) for k, v in third.items()}


def test_jax_checkpoint_resumes_in_the_port(tmp_path, jax_run):
    cfg, ds, variables, batches, jt, saved, third = jax_run
    jt._save(saved, str(tmp_path), cfg.model.name, 2, 0.5, best=False, best_loss=0.25)

    pt = Trainer(cfg, device="cpu")
    st = pt.init_state(bridge.init_variables(S, WIDTHS, seed=9))
    st, epoch, best = pt.restore(st, str(tmp_path / "ico2ico_E2.ckpt"))
    assert (epoch, best, st.step, pt._host_step) == (2, 0.25, 2, 2)
    ours = adam_state_to_flax(st.optimizer, pt.model.named_parameters(), st.step)
    adam = saved.opt_state[0]
    for key, ref in (("mu", adam.mu), ("nu", adam.nu)):
        got, want = _leaves(ours["0"][key]), _leaves(jax.tree.map(np.asarray, ref))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{key}{k}")
    assert int(ours["0"]["count"]) == int(adam.count) == 2
    v = pt.variables()
    _assert_same_tree(v["params"], jax.tree.map(np.asarray, saved.params))
    _assert_same_tree(v["batch_stats"], jax.tree.map(np.asarray, saved.batch_stats))

    idx = batches[2]
    got = {k: float(v) for k, v in pt.train_step(
        st, torch.from_numpy(ds.inputs[idx]), torch.from_numpy(ds.targets[idx]),
        torch.ones(B)).items()}
    for k in ("total", "mse"):
        np.testing.assert_allclose(got[k], third[k], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], third["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["lr"], third["lr"], rtol=1e-6)


def test_port_checkpoint_resumes_in_jax(tmp_path, jax_run):
    cfg, ds, variables, batches, jt, saved, _ = jax_run
    pt = Trainer(cfg, device="cpu")
    st = pt.init_state(variables)
    for idx in batches[:2]:
        pt.train_step(st, torch.from_numpy(ds.inputs[idx]), torch.from_numpy(ds.targets[idx]),
                      torch.ones(B))
    pt._save(st, str(tmp_path), cfg.model.name, 2, 0.5, best=True, best_loss=0.5)

    template = _jax_state(jt, bridge.init_variables(S, WIDTHS, seed=9))
    state, epoch, best = jt.restore(template, str(tmp_path / "ico2ico_EB2.ckpt"))
    assert (epoch, best, int(state.step), jt._host_step) == (2, 0.5, 2, 2)
    v = pt.variables()
    _assert_same_tree(jax.tree.map(np.asarray, state.params), v["params"])
    _assert_same_tree(jax.tree.map(np.asarray, state.batch_stats), v["batch_stats"])
    ours = adam_state_to_flax(st.optimizer, pt.model.named_parameters(), st.step)
    adam, sched = jax.tree.map(np.asarray, state.opt_state)
    _assert_same_tree(adam.mu, ours["0"]["mu"])
    _assert_same_tree(adam.nu, ours["0"]["nu"])
    assert int(adam.count) == int(sched.count) == 2
    # and the restored state steps in JAX
    idx = batches[2]
    _, m, _, _ = jt._jit_train_step(state, ds.inputs[idx], ds.targets[idx],
                                    np.ones(B, np.float32), 0)
    assert np.isfinite(float(m["total"]))

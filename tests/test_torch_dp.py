"""Data-parallel training of the port against the JAX package, on the CPU.

Two gloo ranks (``tests/torch_dp_ranks.py``, started once for the module
with a localhost rendezvous) run the scenarios of the JAX package's
tests/test_pallas_dp.py config (s=3, widths (8, 12, 16), global batch 8):

* two Adam steps and an eval of the AE on the default route against the
  JAX ``Trainer`` on one device (``mesh=None``, the XLA route) at the same
  global batch and weights (``bridge.py``): loss and eval to rtol 2e-6,
  the count, the parameters and the BatchNorm statistics to rtol 1e-4 /
  atol 1e-6 (test_pallas_dp.py's bounds for JAX's own DP against one
  device); the ranks' parameters and running statistics bit for bit;
* ``all_reduce_mean``'s gradient, through a BatchNorm-shaped loss in
  float64, against one process's over the whole batch (without the
  all-reduce in its backward each rank's moments gradient is its own);
* the VAE: each rank's generator draws its own eps (rank 0 the one-process
  stream); with eps injected (the global batch's, each rank its rows) two
  DP steps and eval equal the one-process run, and ``last_misc`` is the
  global batch's (mu, logvar);
* the routings whose backward folds the stats cotangent outside the
  kernels (l, on the encoder's chain with JAX's fold set) or inside kernel
  n (the decoder's chain): DP steps equal one process's on the same routing;
* ``merged_block="all"`` under DP runs the split pair: no block merges, and
  the step equals the default route's bit for bit.

``Batches``' slicing, truncation and zero-weight padding are held against
the JAX ``Batches`` over a 2-device ``data_sharding`` in this process.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks_lib
from geniconet_tpu.data.pipeline import Batches as JaxBatches
from geniconet_tpu.parallel import mesh as mesh_lib
from geniconet_tpu.train.config import Config as JaxConfig
from geniconet_tpu.train.trainer import Trainer as JaxTrainer
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.nn.layers import IcoBatchNorm
from geniconet_tpu_torch.parallel import dist

WORLD = 2
REPO = Path(__file__).resolve().parent.parent


def _free_port(avoid=()) -> int:
    """A free localhost port, none of ``avoid`` (ports handed out for
    rendezvous that have not bound them yet)."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in avoid:
            return port


# the training CLI under torchrun: s=3, widths (8, 12, 16), global batch 4,
# 16 synthetic meshes (3 for validation: the eval batch is padded with a
# zero-weight row, which lands on rank 1), one epoch of 4 steps
CLI_ARGS = ["--model", "ico2ico", "--process", "train", "--device", "cpu", "--synthetic", "16",
            "--subdivision", "3", "--widths", "8", "12", "16", "--batch_size", "4",
            "--train_epoch", "1"]
# the CLI in a process without TensorBoard (its import takes seconds; the
# Logger then writes JSONL only)
CLI = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
       "from geniconet_tpu_torch import cli; cli.main(sys.argv[1:])")


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    """The training CLI's two rank processes, started as torchrun starts them
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), rank r with ``--logDir OUT/rank<r>``
    and its output in ``OUT/log<r>``: (the processes, OUT, the port).
    ``ranks`` starts them so that they run beside the scenario ranks;
    ``test_torchrun_cli_trains_data_parallel`` waits for them."""
    out = tmp_path_factory.mktemp("cli")
    port = _free_port()
    base = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]), "OMP_NUM_THREADS": "2",
        "WORLD_SIZE": str(WORLD), "LOCAL_WORLD_SIZE": str(WORLD), "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port)}
    procs = []
    for r in range(WORLD):
        with open(out / f"log{r}", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CLI, *CLI_ARGS, "--logDir", str(out / f"rank{r}")],
                env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=log,
                stderr=subprocess.STDOUT))
    yield procs, out, port
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cli_ranks):
    """Both ranks' results of every scenario (``torch_dp_ranks.SCENARIOS``),
    their logs, and the JAX single-device run (``_jax_single_device``),
    which runs here while the ranks do (and the CLI's, ``cli_ranks``)."""
    out = tmp_path_factory.mktemp("dp")
    port = _free_port(avoid=(cli_ranks[2],))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])}
    procs = [subprocess.Popen([sys.executable, ranks_lib.__file__, str(r), str(WORLD), str(port),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        ref = _jax_single_device()
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], logs, ref


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else {f"{prefix}/{k}": v})
    return out


def _close_trees(got, ref, rtol, atol):
    got, ref = _leaves(got), _leaves(ref)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


def _jax_single_device():
    """Two steps and an eval of the JAX Trainer on one device (XLA route) at
    the global batch, from the same weights."""
    cfg = JaxConfig()
    cfg.model.subdivisions, cfg.model.widths = ranks_lib.S, ranks_lib.WIDTHS
    cfg.train.batch_size, cfg.train.log_grad_freq = ranks_lib.B, 0
    ds = synthetic_dataset(ranks_lib.S, ranks_lib.B, seed=0)
    x, y = ds.inputs, ds.targets
    wt = np.ones(ranks_lib.B, np.float32)
    jt = JaxTrainer(cfg)
    state = jt.init_state(x[:1], seed=3)
    v = ranks_lib.variables("ico2ico")
    params = jax.tree.map(jnp.asarray, v["params"])
    state = state.replace(params=params, opt_state=jt.tx.init(params),
                          batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]))
    steps = []
    for _ in range(2):
        state, m, _, _ = jt._jit_train_step(state, x, y, wt, 0)
        steps.append({k: float(val) for k, val in jax.device_get(m).items()})
    ev, cnt = jt._jit_eval_step(state, x, y, wt, 0)
    return steps, {k: float(val) for k, val in jax.device_get(ev).items()}, float(cnt), \
        jax.device_get({"params": state.params, "batch_stats": state.batch_stats})


def test_dp_ae_steps_match_the_jax_single_device_steps(ranks):
    (r0, r1), _, (steps, ev, cnt, variables) = ranks
    for r in (r0, r1):
        got = r["ae"]
        for g, s in zip(got["steps"], steps, strict=True):
            np.testing.assert_allclose(g["total"], s["total"], rtol=2e-6)
            np.testing.assert_allclose(g["mse"], s["mse"], rtol=2e-6)
            np.testing.assert_allclose(g["grad_norm"], s["grad_norm"], rtol=1e-4)
            assert g["finite"] == 1.0
        np.testing.assert_allclose(got["eval"]["total"], ev["total"], rtol=2e-6)
        assert got["count"] == cnt == 8.0
        _close_trees(got["variables"], variables, rtol=1e-4, atol=1e-6)
    assert r0["dp"] == "rank 0 of 2 on cpu, backend gloo"
    # every rank holds the same parameters and running statistics, bit for bit
    bits = r0["ae"]["bits"]
    assert bits.shape[0] == WORLD and (bits == bits[:1]).all()
    np.testing.assert_array_equal(bits, r1["ae"]["bits"])


def test_all_reduce_mean_gradient_matches_one_process(ranks):
    (r0, r1), _, _ = ranks
    ref = ranks_lib.bn_moments_grad(None)
    got = np.concatenate([r0["bn_grad"], r1["bn_grad"]])
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    # a backward that left the moments' cotangent on its own rank gives
    # another gradient, far outside the bound above
    bare = ranks_lib.bn_moments_grad(None, own_cotangent=True, world=WORLD)
    assert np.abs(bare - ref).max() > 1e-2 * np.abs(ref).max()


def test_vae_ranks_draw_their_own_eps_and_injected_eps_steps_equal_one_process(ranks):
    (r0, r1), _, _ = ranks
    one = ranks_lib.vae_steps(None)
    assert all(s["grad_norm"] < 100.0 for s in one["steps"])  # no near-zero normal
    np.testing.assert_array_equal(r0["vae"]["draws"], one["draws"])
    assert not np.allclose(r1["vae"]["draws"], r0["vae"]["draws"])
    # the position, Laplacian and KL terms to 2e-6; the normal term's cosine
    # (and the totals it enters) to 2e-5: over an untrained decoder's mesh it
    # amplifies the reconstruction's float32 rounding (its positions 1e-7
    # apart) about 50-fold, as in one process against another order of sums
    tol = {"mse": 2e-6, "lap": 2e-6, "kld": 2e-6, "cos": 2e-5, "recon": 2e-5, "total": 2e-5}
    for r in (r0, r1):
        got = r["vae"]
        for g, s in zip([*got["steps"], got["eval"]], [*one["steps"], one["eval"]], strict=True):
            for k, rtol in tol.items():
                np.testing.assert_allclose(g[k], s[k], rtol=rtol, err_msg=k)
        for g, s in zip(got["steps"], one["steps"], strict=True):
            np.testing.assert_allclose(g["grad_norm"], s["grad_norm"], rtol=1e-4)
        assert got["count"] == one["count"] == 8.0
        _close_trees(got["variables"], one["variables"], rtol=1e-4, atol=1e-6)
        for a, b in zip(got["misc"], one["misc"], strict=True):  # the global batch's
            assert a.shape == b.shape and a.shape[0] == ranks_lib.B
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    np.testing.assert_array_equal(r0["vae"]["bits"], r1["vae"]["bits"])


@pytest.mark.parametrize("route", list(ranks_lib.FOLD_ROUTES))
def test_dp_steps_equal_one_process_where_the_stats_fold_moves(ranks, route):
    """The BatchNorms' reduced moments cotangent reaches the fold wherever it
    runs: outside the kernels (kernel l's plain version, on the encoder's
    chain with JAX's fold set) and inside kernel n's backward (the
    decoder's chain). Two DP steps and eval equal one process's on the same
    routing at the same bounds."""
    (r0, r1), _, _ = ranks
    one = ranks_lib.steps(None, **ranks_lib.FOLD_ROUTES[route])
    for r in (r0, r1):
        got = r[route]
        for g, s in zip(got["steps"], one["steps"], strict=True):
            np.testing.assert_allclose(g["total"], s["total"], rtol=2e-6)
            np.testing.assert_allclose(g["grad_norm"], s["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["eval"]["total"], one["eval"]["total"], rtol=2e-6)
        _close_trees(got["variables"], one["variables"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(r0[route]["bits"], r1[route]["bits"])


def test_merged_block_under_dp_takes_the_split_pair(ranks):
    (r0, r1), logs, _ = ranks
    for r in (r0, r1):
        assert r["merged_block"]["merged"] and not any(r["merged_block"]["merged"])
        assert r["merged_block"]["steps"][0] == r["ae"]["steps"][0]
    assert "merged_block='all' runs each block's split pair" in logs[0]
    assert "split pair" not in logs[1]  # rank 0 alone prints


@pytest.mark.parametrize("shuffle,drop", [(True, None), (True, False), (False, None)])
def test_batches_slice_as_the_jax_sharded_batches(shuffle, drop):
    """11 meshes, global batch 4 over 2 ranks: the training loader drops the
    ragged tail (or cuts it to 2 rows), the eval loader pads it with a
    zero-weight row; rank r holds JAX shard r of every global batch."""
    ds = synthetic_dataset(1, 11, seed=0)
    sharding = mesh_lib.data_sharding(mesh_lib.make_mesh(WORLD))
    ref = JaxBatches(ds, 4, shuffle=shuffle, drop_remainder=drop, sharding=sharding, seed=7,
                     device_resident=False)
    ours = [Batches(ds, 4, shuffle=shuffle, drop_remainder=drop, seed=7, device="cpu", rank=r,
                    world=WORLD) for r in range(WORLD)]
    for _ in range(2):
        want = list(ref.epoch_indices())
        got = [list(b.epoch_indices()) for b in ours]
        assert [len(g) for g in got] == [len(want)] * WORLD == [len(b) for b in ours]
        for k, (idx, wt) in enumerate(want):
            half = len(idx) // WORLD
            for r in range(WORLD):
                np.testing.assert_array_equal(got[r][k][0], idx[r * half : (r + 1) * half])
                np.testing.assert_array_equal(got[r][k][1], wt[r * half : (r + 1) * half])
        sizes = [len(i) for i, _ in want]
        assert sizes == ([4, 4] if drop is None and shuffle else [4, 4, 2] if shuffle
                         else [4, 4, 4])
        if not shuffle:
            np.testing.assert_array_equal(want[-1][1], [1, 1, 1, 0])
    # JAX places shard r of a batch on device r: the rows rank r gathers
    x = next(iter(JaxBatches(ds, 4, shuffle=False, sharding=sharding,
                             device_resident=False).epoch()))[0]
    for shard in x.addressable_shards:
        r = shard.index[0].start // 2
        mine = next(iter(Batches(ds, 4, shuffle=False, device="cpu", rank=r, world=WORLD)
                         .epoch()))[0]
        np.testing.assert_array_equal(np.asarray(shard.data), mine.numpy())


def test_batches_refuse_a_global_batch_the_ranks_do_not_divide():
    ds = synthetic_dataset(1, 4, seed=0)
    with pytest.raises(ValueError, match="divisible by the 2 ranks"):
        Batches(ds, 5, device="cpu", rank=0, world=2)


def _val_totals(log_dir):
    with open(log_dir / "ae" / "events.jsonl") as f:
        return [r["total"] for r in map(json.loads, f) if r.get("prefix") == "val"]


def test_torchrun_cli_trains_data_parallel(cli_ranks, tmp_path, monkeypatch):
    """``python -m geniconet_tpu_torch.cli --process train`` as torchrun
    starts it on two CPU ranks (``cli_ranks``): the process group is gloo,
    ``fit`` runs its epoch and the summed ``validate``, and both ranks exit
    0 after the last barrier and ``destroy_process_group``. Rank 1 is given
    a ``--logDir`` of its own and writes nothing there; rank 0 writes the
    config, the summary, the events and the EB and E checkpoints. The
    validation total equals a one-process CLI run's at the same global
    batch to rtol 1e-5 (after four Adam steps, where test_pallas_dp.py
    holds the parameters to rtol 1e-4 / atol 1e-6; 3e-7 apart here). The
    16 training meshes leave no ragged batch, which JAX truncates to a
    multiple of the device count, so two ranks and one process see the same
    batches."""
    from geniconet_tpu_torch import cli

    procs, out, _ = cli_ranks
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    one = cli.main([*CLI_ARGS, "--logDir", str(tmp_path / "one")])
    for p in procs:
        p.wait(timeout=300)
    logs = [(out / f"log{r}").read_text(errors="replace") for r in range(WORLD)]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert "[train] data parallel: rank 0 of 2 on cpu, backend gloo" in logs[0]
    assert "[train] data parallel: rank 1 of 2 on cpu, backend gloo" in logs[1]
    assert "optimizable parameters" in logs[0] and "optimizable parameters" not in logs[1]
    assert not (out / "rank1").exists()
    ae = out / "rank0" / "ae"
    assert sorted(os.listdir(ae / "savedModel")) == ["ico2ico_E1.ckpt", "ico2ico_EB1.ckpt"]
    assert {"config.json", "events.jsonl", "train_ico2ico_summary.txt"} <= set(os.listdir(ae))
    dp_val, one_val = _val_totals(out / "rank0"), _val_totals(tmp_path / "one")
    assert len(dp_val) == len(one_val) == len(one) == 1
    np.testing.assert_allclose(dp_val, one_val, rtol=1e-5)


def test_kernel_affine_raises_under_dp():
    """The merged blocks' in-kernel affine takes one rank's moments: a
    BatchNorm under data parallelism refuses it before any kernel runs."""
    bn = IcoBatchNorm(4, dp=dist.DataParallel(0, WORLD, "gloo", torch.device("cpu")))
    with pytest.raises(RuntimeError, match="under data parallelism"):
        bn.kernel_affine(lambda scale, bias: pytest.fail("the kernel ran"), 8.0)


@pytest.mark.parametrize("case", ["cpu is gloo", "nccl refused on the cpu", "slices"])
def test_dist_device_map_backend_and_slices(case):
    if case == "cpu is gloo":
        assert dist.device_map(1, 4, "cpu") == (torch.device("cpu"), "gloo")
    elif case == "nccl refused on the cpu":
        with pytest.raises(ValueError, match="nccl"):
            dist.init(backend="nccl", device_type="cpu", rank=0, world=1,
                      init_method="tcp://127.0.0.1:1")
    else:
        assert dist.shard_slice(8, 1, 2) == slice(4, 8)
        with pytest.raises(ValueError, match="does not split"):
            dist.shard_slice(7, 0, 2)

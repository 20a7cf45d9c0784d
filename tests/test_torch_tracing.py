"""The port's span recorder (``geniconet_tpu_torch/tracing.py``) and the
spans at its layer boundaries, on the CPU.

* Off, a span is the one shared no-op object and nothing is recorded.
* On, spans nest by thread: a span opened on a thread with none open (as
  autograd's CUDA backward thread) takes the innermost span of the thread
  that started the unit as parent; a batch's ``data`` span shares the unit
  of the step that consumes it.
* One s=3 AE training step records ``step`` > ``forward`` / ``loss`` /
  ``backward`` / ``update`` (> ``grad_norm``, ``optimizer``) and ``sync``,
  with the autograd Functions' ``kernel.*`` spans under ``forward`` and
  their ``kernel.*.bwd`` under ``backward`` (their plain routes here); one
  ``reconstruct`` records ``reconstruct`` > ``forward``, ``vertices``.
* ``--profile_dir`` writes the spans into its Chrome trace on the trace's
  clock; ``--debug`` prints the epoch's wall time a step.
"""

import json
import threading

import numpy as np
import pytest
import torch

from geniconet_tpu_torch import tracing
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.eval.test_driver import reconstruct
from geniconet_tpu_torch.train.config import Config
from geniconet_tpu_torch.train.trainer import Trainer, fresh_variables

S, WIDTHS, B = 3, (8, 16, 16), 4


@pytest.fixture
def recorder():
    """Start the recorder; stop it whatever the test does."""
    tracing.start()
    try:
        yield
    finally:
        if tracing.active():
            tracing.stop()


@pytest.fixture(scope="module")
def trained():
    """One s=3 AE ``Trainer`` on the CPU and its state, shared (its
    construction is most of this file's time)."""
    cfg = Config()
    cfg.model.subdivisions, cfg.model.widths = S, WIDTHS
    cfg.train.batch_size, cfg.train.log_freq = B, 1
    tr = Trainer(cfg, device="cpu")
    return tr, tr.init_state(fresh_variables(cfg))


def _batches(n=B):
    return Batches(synthetic_dataset(S, n, seed=3), B, seed=7, device="cpu")


def _paths(records):
    """The '/'-joined names from the root to each record."""
    def path(k):
        r = records[k]
        return r.name if r.parent < 0 else f"{path(r.parent)}/{r.name}"
    return [path(k) for k in range(len(records))]


def test_off_records_nothing_and_hands_out_the_shared_noop():
    assert not tracing.active()
    for open_span in (tracing.span, tracing.unit, tracing.ahead):
        s = open_span("x")
        assert s is tracing.OFF
        with s:
            pass
    tracing.start()
    assert tracing.stop() == []
    with pytest.raises(ZeroDivisionError):  # an exception passes through the no-op span
        with tracing.span("x"):
            1 / 0


def test_on_nests_by_thread_and_the_data_span_shares_its_steps_unit(recorder):
    with pytest.raises(RuntimeError):
        tracing.start()  # on already
    workers = []
    for _ in range(2):
        with tracing.ahead("data"):
            pass
        with tracing.unit("step"):
            with tracing.span("forward"):
                with tracing.span("kernel.F"):
                    pass
            with tracing.span("backward"):
                def on_another_thread():
                    with tracing.span("kernel.F.bwd"):
                        workers.append(threading.get_native_id())

                t = threading.Thread(target=on_another_thread)
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
    records = tracing.stop()
    assert _paths(records) == ["data", "step", "step/forward", "step/forward/kernel.F",
                               "step/backward", "step/backward/kernel.F.bwd"] * 2
    assert [r.unit for r in records] == [0] * 6 + [1] * 6
    main = threading.get_native_id()
    assert [r.thread for r in records] == ([main] * 5 + [workers[0]] + [main] * 5
                                           + [workers[1]])
    assert main not in workers
    for r in records:
        assert 0 < r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = records[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_one_training_step_records_each_layer(trained, recorder):
    tr, state = trained
    tr.train_epoch(state, _batches(), epoch=0)
    records = tracing.stop()
    paths = _paths(records)
    step = paths.index("step")
    assert records[paths.index("data")].unit == records[step].unit == 0
    assert {r.unit for r in records} == {0}
    top = {p for p in paths if p.count("/") == 1}
    assert top == {"step/forward", "step/loss", "step/backward", "step/update", "step/sync"}
    assert {"step/update/grad_norm", "step/update/optimizer"} <= set(paths)
    kernels = [p for p in paths if "/kernel." in p]
    fwd = [p for p in kernels if not p.endswith(".bwd")]
    bwd = [p for p in kernels if p.endswith(".bwd")]
    assert fwd and all(p.startswith("step/forward/kernel.") for p in fwd), kernels
    assert bwd and all(p.startswith("step/backward/kernel.") for p in bwd), kernels
    assert "step/forward/kernel.PairHeadMSE" in fwd  # the fused head+MSE route
    assert "step/backward/kernel.PairHeadMSE.bwd" in bwd


def test_reconstruct_records_its_forward_and_vertices(trained, recorder):
    tr, _ = trained
    x = torch.as_tensor(synthetic_dataset(S, 2, seed=5).inputs)
    with torch.no_grad():
        v = reconstruct(tr.model.eval(), x)
    tr.model.train()
    records = tracing.stop()
    paths = _paths(records)
    assert v.shape[0] == 2
    assert paths[:2] == ["reconstruct", "reconstruct/forward"]
    assert "reconstruct/vertices" in paths
    assert any(p.startswith("reconstruct/forward/kernel.") for p in paths)
    assert {r.unit for r in records} == {0}


def test_profile_dir_writes_the_spans_on_the_traces_clock(trained, tmp_path, monkeypatch,
                                                          capsys):
    tr, _ = trained
    monkeypatch.setattr(tr.cfg.train, "profile_dir", str(tmp_path))
    x = torch.as_tensor(synthetic_dataset(S, 1, seed=5).inputs)
    with tr._profiled(True, 1), torch.no_grad():
        reconstruct(tr.model.eval(), x)
    tr.model.train()
    assert not tracing.active()
    with open(tmp_path / "epoch1.trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in spans[:2]] == ["reconstruct", "forward"]
    assert "program spans" in capsys.readouterr().out
    # each Function's forward span holds the host ops its plain route ran
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    kernels = [e for e in spans if e["name"].startswith("kernel.")]
    assert kernels
    for k in kernels:
        inside = [e for e in ops
                  if k["ts"] <= e["ts"] and e["ts"] + e["dur"] <= k["ts"] + k["dur"]]
        assert inside, k


def test_debug_prints_wall_time_a_step(trained, monkeypatch, capsys):
    tr, state = trained
    monkeypatch.setattr(tr.cfg.train, "debug_timing", True)
    _, info = tr.train_epoch(state, _batches(), epoch=0)
    out = capsys.readouterr().out
    assert "[debug] epoch 0: 1 iters in" in out and "ms/iter" in out
    assert "seconds" not in info
    assert np.isfinite(info["last"]["total"])

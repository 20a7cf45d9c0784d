"""Whole runs of the harness, the look for a card skipped, at a size a test
run holds (CPU): a sound program passes; a timed path broken underneath,
and the lower-precision control, come out not correct; the guards refuse
what they must. Tests marked ``cuda`` run a cell on the card and skip
without one."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

from benchmark import calibrate, checks, run, spec
from benchmark.reference import quant

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977  # above 32 signed bits, as run seeds may be


def small(name: str, dtype: str = "float32"):
    """The cell at level 3 with a small pool; the compute dtype float32, so
    that a sound run reads nought but rounding."""
    cell = spec.cell(spec.load(ROOT), name, ROOT)
    cell.traffic.update(subdivisions=3, batch_size=8, pool=40, trace_steps=2)
    if cell.traffic["kind"] == "recon":
        cell.traffic.update(sample_every=2)
    cell.config["model"]["compute_dtype"] = dtype
    return cell


def drive(cell, seconds: float = 1.0) -> dict:
    args = argparse.Namespace(workload=cell.name, seed=SEED, seconds=seconds, trace=0)
    return run.run_cell(cell, args, device="cpu", t0=time.perf_counter())


def _cells(kind):
    bench = spec.load(ROOT)
    return [w["name"] for w in bench["workloads"]
            if spec.cell(bench, w["name"], ROOT).traffic["kind"] == kind]


TRAIN, RECON = _cells("train"), _cells("recon")


@pytest.mark.parametrize("name", TRAIN + RECON)
def test_a_sound_run_is_correct(name):
    out = drive(small(name))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and list(out)[-1] == "compared"


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(name):
    with mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None):
        out = drive(small(name))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out_is_caught(name):
    from geniconet_tpu_torch.train.trainer import Trainer

    loss = Trainer.loss

    def half(self, x, y, wt, *a, **kw):
        h = x.shape[0] // 2
        return loss(self, x[:h], y[:h], wt[:h], *a, **kw)

    with mock.patch.object(Trainer, "loss", half):
        out = drive(small(name))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", RECON)
def test_an_altered_answer_is_caught(name):
    from geniconet_tpu_torch.eval import test_driver

    reconstruct = test_driver.reconstruct

    def rolled(model, x):  # each mesh's vertices handed to the next request
        return torch.roll(reconstruct(model, x), 1, dims=0)

    with mock.patch.object(test_driver, "reconstruct", rolled):
        out = drive(small(name))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", TRAIN + RECON)
def test_the_fp8_control_is_not_correct(name):
    """The reference in 8-bit floats put in the program's place."""
    cell = small(name, "bfloat16")
    if cell.traffic["kind"] == "train":
        rows = calibrate.training(cell, SEED, True, torch.device("cpu"))
    else:
        rows = calibrate.reconstruction(cell, SEED, True, torch.device("cpu"), 20)
    control = next(r for r in rows if r["kind"] == "control_fp8")
    correct, _ = checks.judge({k: control[k] for k in cell.limits}, cell.limits)
    assert not correct, control


def test_the_control_rounds_to_eight_bits():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = quant.fp8(x)
    assert 0 < (y - x).abs().max() < 3 * 2**-4
    assert len(torch.unique(y)) < 101
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", TRAIN[0],
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == "", (p.returncode, p.stdout)
    assert "CUDA" in p.stderr


def test_the_guard_compares_whole_top_level_names():
    with mock.patch.dict(sys.modules, {"geniconet_tpu_torch.x": mock.Mock()}):
        assert "geniconet_tpu_torch.x" not in run.loaded_tops()
    for name in ("geniconet_tpu", "geniconet_tpu.nn", "jax.numpy", "flax", "optax", "jaxlib"):
        with mock.patch.dict(sys.modules, {name: mock.Mock()}):
            assert run.loaded_tops() == [name]
            with pytest.raises(run.Refused):
                run.guard("now")


@pytest.mark.parametrize("imports", ["jax", None])
def test_a_reader_that_loads_jax_refuses_the_run(tmp_path, capsys, imports):
    """A per-layer reader runs after the window's guard: a module of JAX that
    it loads (here a stand-in named ``jax``) is still found before the
    result is printed, and the run gives none."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "benchmark" / "metrics").mkdir(parents=True)
    (tmp_path / "benchmark" / "metrics" / "loads.train.py").write_text(
        (f"import {imports}\n" if imports else "") + "def read(r):\n    return 1.0\n")

    def run_cell(cell, args):  # the window left out; a reader as run_cell calls it
        value = spec.reader("loads.train", tmp_path)(None)
        return {"correct": True, "attempted": 1, "failed": 0,
                "metrics": {"loads.train": {"value": value, "unit": "count"}},
                "device": {}, "compared": {}}

    program = [m for m in sys.modules if m.split(".", 1)[0] == run.PROGRAM]
    with mock.patch.dict(sys.modules), \
            mock.patch.object(sys, "path", [str(tmp_path), *sys.path]), \
            mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "device_count", lambda: 4), \
            mock.patch.object(run, "run_cell", run_cell):
        for m in program:  # as in a fresh process, the program is not loaded yet
            del sys.modules[m]
        rc = run.main(["--workload", TRAIN[0], "--seed", str(SEED), "--seconds", "1",
                       "--trace", "1"])
    out, err = capsys.readouterr()
    if imports:
        assert rc != 0 and out == "" and "before the result" in err and "'jax'" in err, err
    else:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"], err


def test_the_reference_loads_nothing_of_either_package():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.train, "
            "benchmark.reference.quant, benchmark.data, benchmark.weights, benchmark.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'geniconet_tpu_torch', 'geniconet_tpu', 'jax', 'flax', 'optax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", (p.stdout, p.stderr)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + RECON)
def test_a_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                        str(SEED), "--seconds", "3", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu", out

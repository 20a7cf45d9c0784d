"""The join of the program's spans with a traced stretch
(``benchmark/spans.py``): on a hand-written stretch whose values are worked
out by hand, with a mark's clock put off by 1 ms, and in a whole CPU run of
each cell with the recorder on."""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import pytest

from benchmark import spans, trace
from benchmark.tests.test_bench_drive import RECON, SEED, TRAIN, small
from geniconet_tpu_torch import tracing
from geniconet_tpu_torch.tracing import Record

OFFSET = 1000.0  # trace µs minus host µs
MAIN, AUTOGRAD = 11, 12  # native ids
IDENTS = {MAIN: 0x7F0003E53000, AUTOGRAD: 0x7F00C9404C40}  # pthread ids
# the trace's thread ids: the low 32 bits of the pthread id as a signed
# number, without its sign
TID = {MAIN: 0x03E53000, AUTOGRAD: (1 << 32) - 0xC9404C40}
US = 1000  # ns


def _records():
    return [r._replace(ident=IDENTS[r.thread]) for r in _plain_records()]


def _plain_records():
    r = [  # unit 0, inside the stretch
        Record("data", -1, MAIN, 10_100 * US, 10_300 * US, 0),
        Record("step", -1, MAIN, 10_400 * US, 19_000 * US, 0),
        Record("forward", 1, MAIN, 10_500 * US, 12_000 * US, 0),
        Record("kernel.F", 2, MAIN, 10_600 * US, 11_000 * US, 0),
        Record("backward", 1, MAIN, 12_500 * US, 15_000 * US, 0),
        Record("kernel.F.bwd", 4, AUTOGRAD, 13_000 * US, 13_500 * US, 0),
        Record("update", 1, MAIN, 15_500 * US, 16_500 * US, 0),
        Record("sync", 1, MAIN, 17_000 * US, 18_000 * US, 0),
        # on the main thread, opened after kernel.F.bwd and open at its
        # launch: the launch is kernel.F.bwd's all the same (its thread's)
        Record("wait", 4, MAIN, 13_100 * US, 13_400 * US, 0),
    ]
    r += [  # unit 1, after the stretch
        Record("step", -1, MAIN, 25_000 * US, 26_000 * US, 1),
        Record("forward", 9, MAIN, 25_100 * US, 25_600 * US, 1),
        Record("kernel.F", 10, MAIN, 25_200 * US, 25_500 * US, 1),
        Record("backward", 9, MAIN, 25_650 * US, 25_950 * US, 1),
        Record("kernel.F.bwd", 12, AUTOGRAD, 25_700 * US, 25_800 * US, 1),
    ]
    return r


def _call(c, name, host_us, thread, dur=2.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": host_us + OFFSET,
            "dur": dur, "tid": TID[thread], "args": {"correlation": c}}


def _dev(c, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": c}}


def _stretch(mark_shift_ns: int = 0):
    """Host clock 10,000-20,000 µs; the trace's is 1,000 µs ahead."""
    host = [
        _call(1, "cudaMemcpyAsync", 10_150, MAIN, 10), _call(2, "cudaStreamSynchronize",
                                                            10_200, MAIN, 80),
        _call(3, "cudaLaunchKernel", 10_700, MAIN), _call(4, "cudaLaunchKernel", 11_500, MAIN),
        _call(5, "cudaLaunchKernel", 13_200, AUTOGRAD),
        _call(6, "cudaLaunchKernel", 14_000, AUTOGRAD),  # no span on its thread: backward's
        _call(7, "cudaLaunchKernel", 16_000, MAIN), _call(8, "cudaMemcpyAsync", 17_100, MAIN),
        _call(9, "cudaStreamSynchronize", 17_200, MAIN, 700),
        _call(10, "cudaLaunchKernel", 19_500, MAIN),  # in no span
        _call(100, "cudaLaunchKernel", 10_001, MAIN), _call(101, "cudaLaunchKernel", 20_000, MAIN),
    ]
    events = [_dev(1, 11_200, 100, "gpu_memcpy"), _dev(3, 11_800, 500), _dev(4, 12_400, 200),
              _dev(5, 14_300, 300), _dev(6, 15_100, 400), _dev(7, 17_050, 250),
              _dev(8, 18_200, 50, "gpu_memcpy"), _dev(10, 20_600, 100)]
    markers = [_dev(100, 11_005, 1000, name="spin_kernel"),
               _dev(101, 21_005, 1000, name="spin_kernel")]
    return SimpleNamespace(
        host0=10_000 * US, host1=20_000 * US, offset_us=OFFSET, events=events,
        host_events=host, marker_events=markers,
        marks=[(10_000 * US, 10_004 * US),
               (19_999 * US + mark_shift_ns, 20_003 * US + mark_shift_ns)],
        spans=[("data", 10_100 * US, 10_300 * US), ("step", 10_400 * US, 19_000 * US)])


def test_the_readers_on_a_hand_written_trace():
    out = spans.readings("train", _stretch(), _records(), 1)
    m = out["metrics"]
    assert out["offsets_us"] == pytest.approx([OFFSET, OFFSET])
    assert m["forward_ms.train"] == pytest.approx(0.7)  # its kernel.F's 0.5 and its own 0.2
    assert m["backward_ms.train"] == pytest.approx(0.7)  # both launches of autograd's thread
    assert m["loss_ms.train"] == 0.0
    assert m["update_ms.train"] == pytest.approx(0.25)
    assert out["data_ms"] == pytest.approx(0.1)
    assert m["host_wait_ms.train"] == pytest.approx(0.78)
    assert m["syncs_per_step.train"] == 2
    assert out["coverage"] == pytest.approx(100 * 1800 / 1900)
    assert m["wrapper_ms.train"] == pytest.approx(0.4)  # unit 1: 0.3 + 0.1, both threads
    assert out["by_path"]["step/sync"] == pytest.approx([0.05, 0.0, 0.702, 0.7, 1])
    assert out["by_path"]["step/forward"][:2] == pytest.approx([0.2, 0.2])  # glue: no library
    assert out["by_path"]["step/backward/kernel.F.bwd"][0] == pytest.approx(0.3)
    assert out["by_path"]["-/other"][0] == pytest.approx(0.1)
    assert out["coverage_program"] == out["coverage"]  # no benchmark copy here
    assert out["host_self_ms"]["step/backward"] == pytest.approx(0.2)
    gaps = out["idle_gaps"]
    plain = trace.idle_gaps(_stretch())
    assert [g[1] for g in gaps] == [g[1] for g in plain]
    assert [g[0].split("/")[0] for g in gaps] == [g[0] for g in plain]
    assert gaps[0] == ["step/step", pytest.approx(2350e-6)]
    assert gaps[2] == ["step/update", pytest.approx(1550e-6)]
    assert spans.spans_line(out).startswith(
        "spans coverage 94.737% (program 94.737%) offsets_us 1000.000 1000.000 apart_us 0.000")


def test_a_clock_off_by_a_millisecond_gives_no_reading():
    out = spans.readings("train", _stretch(mark_shift_ns=1000 * US), _records(), 1)
    assert abs(out["offsets_us"][0] - out["offsets_us"][1]) == pytest.approx(1000)
    m = out["metrics"]
    assert all(m[k] is None for k in m if k != "wrapper_ms.train"), m
    assert out["coverage"] is None
    assert out["idle_gaps"] == trace.idle_gaps(_stretch())  # the benchmark's labels alone


@pytest.mark.parametrize("name", TRAIN + RECON)
def test_a_whole_cpu_run_with_the_recorder_on(name):
    cell = small(name)
    args = argparse.Namespace(workload=name, seed=SEED, seconds=1.0, trace=0)
    out = spans.run(cell, args, device="cpu", t0=time.perf_counter())
    assert out["correct"], out["compared"]
    assert not tracing.active()
    assert out["records"] > 0
    m = out["spans"]["metrics"]
    kind = cell.traffic["kind"]
    assert m[f"wrapper_ms.{kind}"] > 0
    assert all(v is None for k, v in m.items() if not k.startswith("wrapper_ms")), m
    top = {p.split("/")[0] for p in out["spans"]["host_self_ms"]}
    assert top == ({"data", "step"} if kind == "train" else {"reconstruct"})

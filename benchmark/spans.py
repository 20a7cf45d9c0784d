"""The program's own spans (``geniconet_tpu_torch/tracing.py``) joined with
a traced stretch: device time by layer, host waits on the card, and the
wrappers' host time; and a run of one cell with the span recorder on.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, on a card. It runs the cell as ``run.py
--trace 1`` does, with two additions: the recorder is on from the end of
set-up to the end of the window, and the stretch (``SpanStretch``) keeps
the host's CUDA runtime calls of its trace and the host clock on both
sides of each marker launch. Standard error gets one ``spans`` line; the
last line of standard output is one JSON object: ``correct``, every
per-layer metric of the cell as ``run.py`` reads it, and the span readings
below under ``spans``. ``BENCHMARK.json`` lists none of these readings:
the harness's drivers and stretch do not yet turn the recorder on or keep
the runtime calls (PERF.md, open questions).

One clock. Kineto's CUDA activity records each runtime call on the host
(``cat`` ``cuda_runtime`` or ``cuda_driver``) with the correlation id of
the kernel, copy or memset it launched. The offset from the trace's clock
to ``perf_counter_ns`` is read from the ``cudaLaunchKernel`` of each of
the stretch's two marker kernels, whose launch the host clock brackets;
the two offsets must agree within ``CLOCK_US`` or the readers give None.

Attribution. A device event belongs to the innermost program span open
on the launching thread at its launch's host time; where that thread has
none open (autograd's device thread between two Functions), to the
innermost span open on any other thread then. The trace names a runtime
call's thread by the low 32 bits of its pthread id (a record's ``ident``)
read as a signed number, without its sign (seen with torch 2.11 on an H100).
An event of no program span is put under ``-/<the benchmark's span>``. A synchronising runtime call
(``SYNC_CALLS``, or a ``cudaMemcpy`` that is not ``Async``) belongs to its
span the same way. Device milliseconds are the union of a group's device
events, per unit (step or batch) of the stretch. Host readings use only
the units outside the stretch, which run without CUPTI.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import trace  # noqa: E402

CLOCK_US = 20.0  # the two marker offsets may differ by this much
HOST_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def is_sync(name: str) -> bool:
    return name in SYNC_CALLS or (name.startswith("cudaMemcpy") and "Async" not in name)


class SpanStretch(trace.Stretch):
    """``trace.Stretch`` that also keeps the trace's host runtime calls
    (``host_events``) and ``marks``: the host clock (ns) right before and
    right after each marker launch."""

    def __init__(self):
        super().__init__()
        self.marks: list[tuple[int, int]] = []
        self.host_events = self.marker_events = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.host0 = time.perf_counter_ns()
        torch.cuda._sleep(1000)  # marker: the stretch's first device event
        self.marks.append((self.host0, time.perf_counter_ns()))

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.host1 = time.perf_counter_ns()
        torch.cuda._sleep(1000)  # marker: its last
        self.marks.append((self.host1, time.perf_counter_ns()))
        torch.cuda.synchronize()
        self.prof.stop()

    def read(self) -> bool:
        """``trace.Stretch.read`` (the same ``events`` and ``offset_us``; a
        trace is exported once), keeping the host's runtime calls and the
        marker kernels too."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                everything = [e for e in json.load(f).get("traceEvents", [])
                              if e.get("ph") == "X"]
        finally:
            os.unlink(path)
        events = [e for e in everything if e.get("cat") in trace.DEVICE_CATS]
        marks = sorted((e for e in events if "spin" in e["name"].lower()), key=lambda e: e["ts"])
        events = [e for e in events if "spin" not in e["name"].lower()]
        if not any(e["cat"] == "kernel" for e in events) or len(marks) < 2:
            return False
        self.offset_us = marks[0]["ts"] - self.host0 / 1e3
        self.events, self.marker_events = events, marks
        self.host_events = [e for e in everything if e.get("cat") in HOST_CATS]
        return True


def _corr(e: dict):
    return e.get("args", {}).get("correlation")


def launch_offsets_us(host_events, marker_events, marks) -> list[float]:
    """Trace µs minus host µs at each marker launch: the middle of its
    ``cudaLaunchKernel`` call against the middle of the host clock's
    bracket (the first and the last marker kernel)."""
    calls = {_corr(e): e for e in host_events}
    out = []
    for ev, (t0, t1) in zip((marker_events[0], marker_events[-1]), marks):
        call = calls.get(_corr(ev))
        if call is not None:
            out.append(call["ts"] + call["dur"] / 2 - (t0 + t1) / 2e3)
    return out


class Index:
    """The records by thread, for "innermost span open at time t"."""

    def __init__(self, records):
        self.records = records
        self.native = {}  # a trace's thread id, or a native one -> the native id
        for r in records:
            self.native[r.thread] = r.thread
            if r.ident:
                low = r.ident & 0xFFFFFFFF
                self.native[low if low < 1 << 31 else (1 << 32) - low] = r.thread
        self.by_thread: dict[int, tuple[list, list]] = {}
        for k, r in enumerate(records):
            if r.end_ns:
                self.by_thread.setdefault(r.thread, ([], []))[1].append(k)
        for thread, (starts, ks) in self.by_thread.items():
            ks.sort(key=lambda k: records[k].start_ns)
            starts.extend(records[k].start_ns for k in ks)
        self._paths: dict[int, str] = {}

    def _on_thread(self, thread: int, t: float):
        starts, ks = self.by_thread.get(thread, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return None
        k = ks[i]
        while k >= 0:
            r = self.records[k]
            if r.thread != thread:
                return None
            if r.end_ns >= t:
                return k
            k = r.parent
        return None

    def owner(self, thread: int, t: float):
        """The innermost record open at host time t (ns) on ``thread`` (a
        trace's or a native id), else the innermost (latest started) open
        on any other thread; None."""
        thread = self.native.get(thread, thread)
        k = self._on_thread(thread, t)
        if k is not None:
            return k
        best = None
        for other in self.by_thread:
            if other != thread:
                j = self._on_thread(other, t)
                if j is not None and (best is None or self.records[j].start_ns
                                      > self.records[best].start_ns):
                    best = j
        return best

    def path(self, k: int) -> str:
        if k not in self._paths:
            r = self.records[k]
            self._paths[k] = r.name if r.parent < 0 else f"{self.path(r.parent)}/{r.name}"
        return self._paths[k]

    def self_pieces(self) -> list[tuple[int, int, int]]:
        """[(record, t0, t1)] (ns): each record's interval less its children's."""
        children: dict[int, list] = {}
        for r in self.records:
            if r.parent >= 0 and r.end_ns:
                children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
        pieces = []
        for k, r in enumerate(self.records):
            if not r.end_ns:
                continue
            cur = r.start_ns
            for a, b in sorted(children.get(k, ())):
                if a > cur:
                    pieces.append((k, cur, a))
                cur = max(cur, b)
            if cur < r.end_ns:
                pieces.append((k, cur, r.end_ns))
        return pieces

    def self_ns(self) -> list[int]:
        """Each record's own time: its duration less its children's union."""
        own = [0] * len(self.records)
        for k, a, b in self.self_pieces():
            own[k] += b - a
        return own


class Joined:
    """A stretch and the records of the same run, joined (module doc).
    ``units``: the steps or batches inside the stretch (``Readings``);
    ``port``: the program's kernel names (``trace.Library``), for the glue."""

    def __init__(self, stretch, records, units: int, port=frozenset()):
        self.stretch, self.records, self.units, self.port = stretch, records, units, port
        self.index = Index(records)
        self.offsets = launch_offsets_us(stretch.host_events or [], stretch.marker_events,
                                         stretch.marks) if stretch.marker_events else []
        self.ok = (len(self.offsets) == 2 and abs(self.offsets[0] - self.offsets[1]) <= CLOCK_US
                   and units > 0)
        self.owned: list[tuple[dict, str | None]] = []  # (device event, span path)
        self.calls: list[tuple[dict, str | None]] = []  # (runtime call, span path)
        if not self.ok:
            return
        offset = self.offsets[0]
        bench = sorted(stretch.spans, key=lambda s: s[1])
        starts = [s[1] for s in bench]
        paths = {}
        for e in stretch.host_events:
            t = (e["ts"] - offset) * 1e3
            k = self.index.owner(e["tid"], t)
            if k is not None:
                path = self.index.path(k)
            else:
                i = bisect.bisect_right(starts, t) - 1
                path = "-/" + (bench[i][0] if i >= 0 and bench[i][2] >= t else "other")
            paths[_corr(e)] = path
            self.calls.append((e, path))
        self.owned = [(e, paths.get(_corr(e), "-/other")) for e in stretch.events]

    def under(self, name: str):
        """Device ms a unit of the events whose span, or an ancestor of it,
        is named ``name``; None when the clocks disagree."""
        if not self.ok:
            return None
        return trace.busy_seconds([e for e, p in self.owned if name in p.split("/")]) \
            * 1e3 / self.units

    def coverage(self, but=()):
        """Share of the stretch's device busy time attributed to a program
        span (%), leaving out the events under the paths ``but``."""
        if not self.ok:
            return None
        kept = [(e, p) for e, p in self.owned if p not in but]
        return 100.0 * trace.busy_seconds([e for e, p in kept if not p.startswith("-")]) \
            / trace.busy_seconds([e for e, _ in kept])

    def _waits(self):
        return [e for e, p in self.calls if is_sync(e["name"]) and not p.startswith("-")]

    def host_wait_ms(self):
        """Host ms a unit in synchronising runtime calls inside program spans."""
        if not self.ok:
            return None
        return sum(e["dur"] for e in self._waits()) / 1e3 / self.units

    def syncs_per_unit(self):
        if not self.ok:
            return None
        return len(self._waits()) / self.units

    def by_path(self) -> dict:
        """{span path: [device ms, of it glue ms, runtime-call host ms,
        synchronising-call host ms, synchronising calls] a unit} in the
        stretch. Glue: memsets and kernels the program's library did not
        build."""
        dev: dict[str, list] = {}
        for e, p in self.owned:
            dev.setdefault(p, []).append(e)
        host: dict[str, list] = {}
        for e, p in self.calls:
            row = host.setdefault(p, [0.0, 0.0, 0])
            row[0] += e["dur"] / 1e3
            if is_sync(e["name"]):
                row[1] += e["dur"] / 1e3
                row[2] += 1
        def glue(e):
            return e["cat"] == "gpu_memset" or (e["cat"] == "kernel"
                                                and not trace.is_port_kernel(e, self.port))

        n = self.units
        return {p: [trace.busy_seconds(dev.get(p, ())) * 1e3 / n,
                    trace.busy_seconds([e for e in dev.get(p, ()) if glue(e)]) * 1e3 / n,
                    *(x / n for x in host.get(p, (0.0, 0.0, 0)))]
                for p in sorted(set(dev) | set(host))}

    def gap_labels(self) -> list[list]:
        """``trace.idle_gaps`` with each label ``<benchmark span>/<program
        span>``: the span whose own time (its children's left out) covers
        most of the gap, or "other"."""
        bench = trace.idle_gaps(self.stretch)
        if not self.ok:
            return bench
        st = self.stretch
        own = SimpleNamespace(host0=st.host0, host1=st.host1, events=st.events,
                              offset_us=st.offset_us,
                              spans=[(self.records[k].name, a, b)
                                     for k, a, b in self.index.self_pieces()])
        return [[f"{b[0]}/{p[0]}", b[1]] for b, p in zip(bench, trace.idle_gaps(own))]


def outside_units(records, stretch) -> dict:
    """{unit: [record indices]} of the units whose every record lies
    outside the stretch's host interval (all units when there is none)."""
    units: dict[int, list] = {}
    for k, r in enumerate(records):
        units.setdefault(r.unit, []).append(k)
    if stretch is None or stretch.host0 is None:
        return units
    h0, h1 = stretch.host0, stretch.host1
    return {u: ks for u, ks in units.items()
            if all(records[k].end_ns and (records[k].end_ns < h0 or records[k].start_ns > h1)
                   for k in ks)}


def wrapper_ms(records, stretch):
    """Median over the units outside the stretch of the host ms of their
    ``kernel.*`` spans' own time, on every thread."""
    units = outside_units(records, stretch)
    if not units:
        return None
    own = Index(records).self_ns()
    return statistics.median(
        sum(own[k] for k in ks if records[k].name.startswith("kernel.")) / 1e6
        for ks in units.values())


def host_self_ms(records, stretch) -> dict:
    """{span path: mean host ms a unit of its own time}, outside the stretch."""
    units = outside_units(records, stretch)
    if not units:
        return {}
    index = Index(records)
    own = index.self_ns()
    out: dict[str, float] = {}
    for ks in units.values():
        for k in ks:
            p = index.path(k)
            out[p] = out.get(p, 0.0) + own[k] / 1e6
    return {p: v / len(units) for p, v in out.items()}


def readings(kind: str, stretch, records, units: int, port=frozenset()) -> dict:
    """The span readings of a run: the eight metrics (None where there is
    nothing to read) and what the ``spans`` line prints. ``coverage_program``
    leaves out the device time under the benchmark's own ``copy`` spans."""
    traced = stretch if stretch is not None and getattr(stretch, "host_events", None) else None
    joined = Joined(traced, records, units, port) if traced is not None else None
    ok = joined is not None and joined.ok
    out = {f"wrapper_ms.{kind}": wrapper_ms(records, stretch)}
    if kind == "train":
        for name in ("forward", "backward", "loss", "update"):
            out[f"{name}_ms.train"] = joined.under(name) if joined else None
        out["host_wait_ms.train"] = joined.host_wait_ms() if joined else None
        out["syncs_per_step.train"] = joined.syncs_per_unit() if joined else None
    return {
        "metrics": out,
        "offsets_us": joined.offsets if joined else [],
        "mark_widths_us": [(b - a) / 1e3 for a, b in traced.marks] if traced else [],
        "coverage": joined.coverage() if joined else None,
        "coverage_program": joined.coverage(but=("-/copy",)) if joined else None,
        "data_ms": joined.under("data") if joined and kind == "train" else None,
        "busy_ms": trace.busy_seconds(traced.events) * 1e3 / units if traced and units else None,
        "by_path": joined.by_path() if ok else {},
        "host_self_ms": host_self_ms(records, stretch),
        "idle_gaps": joined.gap_labels() if joined else [],
        "records_per_unit": len(records) / max(len({r.unit for r in records}), 1),
        "unmapped_tids": sorted({e["tid"] for e in traced.host_events}
                                - set(joined.index.native)) if traced else [],
        "calls": _calls(traced.host_events, units) if traced else {},
    }


def _calls(host_events, units: int) -> dict:
    """{runtime call: [count, host ms] a unit} over the stretch."""
    out: dict[str, list] = {}
    for e in host_events:
        row = out.setdefault(e["name"], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] / 1e3
    return {k: [n / max(units, 1), ms / max(units, 1)] for k, (n, ms) in out.items()}


def spans_line(r: dict) -> str:
    """The one stderr line: per span path a unit, device ms (of it glue),
    host self ms (outside the stretch), runtime-call host ms, synchronising
    calls' host ms and count; the coverage; the two clock offsets."""
    rows = []
    for p in sorted(set(r["by_path"]) | set(r["host_self_ms"])):
        dev, glue, calls, wait, n = r["by_path"].get(p, (0.0,) * 5)
        rows.append(f"{p} dev {dev:.4f} glue {glue:.4f} self {r['host_self_ms'].get(p, 0.0):.4f} "
                    f"calls {calls:.4f} wait {wait:.4f} syncs {n:.3f}")
    off = r["offsets_us"]
    apart = f"{abs(off[0] - off[1]):.3f}" if len(off) == 2 else "none"
    cov = ("none" if r["coverage"] is None
           else f"{r['coverage']:.3f}% (program {r['coverage_program']:.3f}%)")
    return (f"spans coverage {cov} offsets_us {' '.join(f'{o:.3f}' for o in off) or 'none'} "
            f"apart_us {apart} | " + " | ".join(rows))


def run(cell, args, device: str = "cuda", t0: float | None = None) -> dict:
    """One cell as ``run.run_cell`` runs it, with the recorder on from the
    end of set-up to the end of the window and ``SpanStretch`` in place of
    the stretch."""
    from benchmark import checks, spec
    from benchmark import run as bench

    from geniconet_tpu_torch import tracing

    class Hooks(bench.Hooks):
        def setup_done(self):
            super().setup_done()
            tracing.start()

    hooks = Hooks(time.perf_counter() if t0 is None else t0)
    hooks.mark("imports")
    plain, trace.Stretch = trace.Stretch, SpanStretch
    try:
        out = spec.driver(cell.traffic["kind"]).run(cell, args, hooks, device)
    finally:
        trace.Stretch = plain
        records = tracing.stop() if tracing.active() else []
    bench.guard("after the window")
    correct, compared = checks.judge(out["numbers"], cell.limits)
    r = out["readings"]
    metrics = {}
    if args.trace:
        from geniconet_tpu_torch.ops.kernels import build

        r.port = trace.Library(build.library()._name)
        metrics = {m["name"]: spec.reader(m["name"])(r) for m in cell.per_layer}
    result = readings(r.kind, r.stretch, records, r.stretch_units, r.port)
    return {"correct": correct, "end_to_end": out["end_to_end"], "metrics": metrics,
            "spans": result, "records": len(records), "compared": compared}


def main(argv=None) -> int:
    from benchmark import run as bench
    from benchmark import spec

    args = bench.parse(argv)
    import torch

    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("refused: needs a CUDA device", file=sys.stderr)
        return 2
    out = run(cell, args, t0=bench.T0)
    print(spans_line(out["spans"]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

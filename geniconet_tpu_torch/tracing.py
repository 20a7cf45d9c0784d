"""The port's span recorder: host spans at the program's layer boundaries.

Off by default. A span then costs one check of the module global ``_ON``
and hands back the one shared no-op object ``OFF``: nothing is allocated
and no clock is read. Between ``start()`` and ``stop()`` every span keeps a
``Record`` in memory, and ``stop()`` hands them over; nothing is written
while the recorder is on.

A record holds its name, the index of its parent record (-1 for none), the
OS thread that opened it (``threading.get_native_id()``), its start and end
on ``time.perf_counter_ns()``, its unit: the number that every span of
one training step or one reconstruction shares, and the thread's
``threading.get_ident()`` (the pthread id, by whose low 32 bits a
profiler trace names the thread of a CUDA runtime call). ``unit(name)`` opens a
root span that starts the next unit; ``ahead(name)`` opens a root span that
belongs to the unit started next (a batch's fetch, before the step that
consumes it); ``span(name)`` opens a child of the innermost span open on
its thread. A span opened on a thread that has none open (autograd runs a
CUDA backward on a thread of its own) takes as parent the innermost span
open on the thread that started the current unit.

``clock_mark`` and ``add_to_chrome_trace`` place the records on a
``torch.profiler`` trace's clock and write them into its Chrome trace as a
track of their own (``Trainer``'s ``--profile_dir``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import NamedTuple

__all__ = ["Record", "OFF", "span", "unit", "ahead", "start", "stop", "active", "clock_mark",
           "add_to_chrome_trace"]


class Record(NamedTuple):
    name: str
    parent: int  # index of the parent record in the list ``stop()`` returns, -1 for none
    thread: int  # threading.get_native_id() of the thread that opened it
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    unit: int
    ident: int = 0  # threading.get_ident() of that thread


class _Off:
    """The span handed out while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):  # None: an exception propagates
        pass


OFF = _Off()

_ON = False
_records: list = []  # [name, parent, thread, start_ns, end_ns, unit, ident] while on
_local = threading.local()  # .stack: indices of the spans open on this thread; .thread, .ident
_root_stack: list = []  # the stack of the thread that started the current unit
_unit = -1  # the last unit started


class _Span:
    __slots__ = ("kind", "name", "records", "stack", "index")

    def __init__(self, name: str, kind: int):
        self.name, self.kind = name, kind

    def __enter__(self):
        global _unit, _root_stack
        local = _local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.thread, local.ident = threading.get_native_id(), threading.get_ident()
        records = self.records = _records
        if self.kind == 1:  # unit(): a root that starts the next unit
            _unit += 1
            _root_stack = stack
            parent, u = -1, _unit
        elif self.kind == 2:  # ahead(): a root of the unit started next
            parent, u = -1, _unit + 1
        else:
            try:  # the unit's thread may close its last span meanwhile
                parent = stack[-1] if stack else _root_stack[-1]
                u = records[parent][5]
            except IndexError:
                parent, u = -1, _unit
        self.stack, self.index = stack, len(records)
        stack.append(self.index)
        records.append([self.name, parent, local.thread, time.perf_counter_ns(), 0, u,
                        local.ident])

    def __exit__(self, exc_type, exc, tb):
        self.records[self.index][4] = time.perf_counter_ns()
        self.stack.pop()


def span(name: str):
    """A child span of the innermost span open on this thread (module doc)."""
    if not _ON:
        return OFF
    return _Span(name, 0)


def unit(name: str):
    """A root span that starts the next unit (a training step, a reconstruction)."""
    if not _ON:
        return OFF
    return _Span(name, 1)


def ahead(name: str):
    """A root span of the unit started next (a batch's fetch)."""
    if not _ON:
        return OFF
    return _Span(name, 2)


def active() -> bool:
    return _ON


def start():
    """Turn the recorder on, with no records. Raises if it is on already."""
    global _ON, _records, _local, _root_stack, _unit
    if _ON:
        raise RuntimeError("the span recorder is on already")
    _records, _local, _root_stack, _unit = [], threading.local(), [], -1
    _ON = True


def stop() -> list[Record]:
    """Turn the recorder off and hand over its records, in the order the
    spans opened. A span still open has end_ns 0."""
    global _ON, _records, _root_stack
    _ON = False
    out = [Record(*r) for r in _records]
    _records, _root_stack = [], []
    return out


def clock_mark(label: str) -> tuple[str, int, int]:
    """Open and close a ``torch.profiler.record_function`` range named
    ``label`` (unique in the trace) between two reads of
    ``perf_counter_ns``: (label, before, after). The range in the trace
    lies between them, which places host times on the trace's clock."""
    import torch

    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(label):
        pass
    return label, t0, time.perf_counter_ns()


def trace_offsets_us(events, marks) -> list[tuple[float, float]]:
    """For each clock mark found among the trace's events: (trace µs minus
    host µs at the mark, half the width of its host bracket in µs), from
    the middle of its range in the trace and the middle of its bracket."""
    middles = {e["name"]: e["ts"] + e.get("dur", 0) / 2 for e in events
               if e.get("cat") == "user_annotation"}
    return [(middles[label] - (t0 + t1) / 2e3, (t1 - t0) / 2e3)
            for label, t0, t1 in marks if label in middles]


def add_to_chrome_trace(path: str, records, marks) -> list[tuple[float, float]]:
    """Write ``records`` into the Chrome trace at ``path`` as ``X`` events
    of a process of their own ("program spans", one row per thread), placed
    on the trace's clock by the mark of ``marks`` (``clock_mark``) with the
    narrowest host bracket. Returns the offsets of every mark found
    (``trace_offsets_us``); the trace is left as it was when none is."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.setdefault("traceEvents", [])
    offsets = trace_offsets_us(events, marks)
    if not offsets:
        return offsets
    offset = min(offsets, key=lambda o: o[1])[0]
    pid = max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0) + 1
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for k, r in enumerate(records):
        if not r.end_ns:
            continue
        events.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
                       "tid": r.thread, "ts": r.start_ns / 1e3 + offset,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"index": k, "parent": r.parent, "unit": r.unit}})
    with open(path, "w") as f:
        f.write(json.dumps(trace))  # one call of the C encoder: json.dump writes piece by piece
    return offsets

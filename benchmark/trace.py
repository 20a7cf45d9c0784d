"""A traced stretch of the window: ``torch.profiler`` on the card's
activity alone (no host-side operator events, which would slow the host
that sets the pace), the device events read back from its Chrome trace,
and what the per-layer readers need from them.

Busy time is the union of the device events (kernels, copies, memsets).
The host's own spans (the benchmark's ``data``, ``step``, ``sync`` and
``copy``) are timed with ``time.perf_counter_ns`` and placed on the
trace's clock by two marker kernels launched right after a synchronize,
one at each end of the stretch; an idle gap is named by the host span that
covers most of it.

Which kernels are the program's own: those whose function name is a
source name in the mangled symbols of the kernel library the program
built (``Library``), so a renamed or new kernel of the library stays
counted.
``kernel_group`` labels the breakdown's rows only.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Stretch:
    """Profile the card from ``start`` to ``stop``; ``span(name)`` records
    a host span meanwhile. ``events`` (device events, µs on the trace's
    clock), ``offset_us`` (trace clock minus host clock) and ``wall_s``
    are filled in by ``read``, after the window."""

    def __init__(self):
        self.spans: list[tuple[str, int, int]] = []
        self.prof = None
        self.host0 = self.host1 = None
        self.events = None
        self.offset_us = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.host0 = time.perf_counter_ns()
        torch.cuda._sleep(1000)  # marker: the stretch's first device event

    def stop(self):
        torch.cuda.synchronize()
        self.host1 = time.perf_counter_ns()
        torch.cuda._sleep(1000)  # marker: its last
        torch.cuda.synchronize()
        self.prof.stop()

    @property
    def wall_s(self) -> float:
        return (self.host1 - self.host0) / 1e9

    def span(self, name: str, t0: int, t1: int):
        self.spans.append((name, t0, t1))

    def read(self) -> bool:
        """Export the trace to a temporary file, keep its device events,
        delete the file. False when the trace holds no kernel (seen on the
        card now and then): the caller takes another stretch."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marks = sorted((e for e in events if "spin" in e["name"].lower()), key=lambda e: e["ts"])
        events = [e for e in events if "spin" not in e["name"].lower()]
        if not any(e["cat"] == "kernel" for e in events) or len(marks) < 2:
            return False
        self.offset_us = marks[0]["ts"] - self.host0 / 1e3
        self.events = events
        return True


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals in µs, in seconds."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def busy_seconds(events, keep=lambda e: True) -> float:
    return union_seconds((e["ts"], e["ts"] + e["dur"]) for e in events if keep(e))


def idle_gaps(stretch: Stretch, top: int = 10) -> list[list]:
    """The ``top`` longest gaps between device activity inside the
    stretch, each [host span name, seconds]."""
    t0 = stretch.host0 / 1e3 + stretch.offset_us
    t1 = stretch.host1 / 1e3 + stretch.offset_us
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in stretch.events)
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, min(a, t1)))
        cur = max(cur, b)
    if cur < t1:
        gaps.append((cur, t1))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    out = []
    for a, b in gaps:
        ha, hb = a - stretch.offset_us, b - stretch.offset_us  # host µs
        best, name = 0.0, "other"
        for sname, s0, s1 in stretch.spans:
            overlap = min(hb, s1 / 1e3) - max(ha, s0 / 1e3)
            if overlap > best:
                best, name = overlap, sname
        out.append([name, (b - a) / 1e6])
    return out


class Library:
    """The program's kernel library file. A kernel is the program's when its
    function name occurs in the file as an Itanium source name (its length
    in digits, then the name), as it does in the mangled symbol of every
    function the library defines."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.blob = f.read()
        self._seen: dict[str, bool] = {}

    def __contains__(self, name: str) -> bool:
        if name not in self._seen:
            self._seen[name] = bool(name) and f"{len(name)}{name}".encode() in self.blob
        return self._seen[name]


def kernel_base(name: str) -> str:
    """A trace kernel name's unqualified function name: ``void
    (anonymous namespace)::f<T, 2>(Args)`` -> ``f``."""
    name = name.replace("(anonymous namespace)", "anon")
    depth, cut = 0, len(name)
    for k, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            cut = k
            break
    head = name[:cut]
    plain, depth = [], 0
    for c in head:
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif depth == 0:
            plain.append(c)
    return "".join(plain).split()[-1].split("::")[-1] if "".join(plain).split() else ""


def is_port_kernel(event: dict, port) -> bool:
    return event.get("cat") == "kernel" and kernel_base(event["name"]) in port


def kernel_group(event: dict) -> str:
    """The breakdown's label of one device event (the profile rows of the
    kernels the program launches today; anything else is "PyTorch ops")."""
    name = event["name"]
    if event.get("cat") != "kernel":
        return event.get("cat", "other")
    dtype = "bf16" if "bfloat16" in name else "fp32"
    pair = "PairCells" in name
    j = "MergedUp" in name
    i = "MergedPhase" in name
    k = "MergedStd" in name
    which = "(n)" if pair else "(j)" if j else "(d)"
    grid = ("(f)" if "StdGrid" in name else "(b)" if "PhaseGrid" in name
            else "(m)" if "SplitGrid" in name else "(i)" if i else "(k)" if k else None)
    dx = ("(a)" if "PhaseGrid" in name else "(f)" if "StdGrid" in name
          else "(m)" if "SplitGrid" in name else "(n)" if pair else "(i)" if i
          else "(j)" if j else "(k)" if k else "(c)")
    if "mma_bwd<" in name:
        return f"mma_bwd<bf16> {'(j)' if j else '(k)' if k else '(i)'}"
    if "up_operand_pass" in name or "pair_join_pass" in name:
        return f"up_operand_pass<{dtype}> {which}"
    if "grid_operand_pass" in name:
        return f"grid_operand_pass<{dtype}> {grid}"
    if "cot_operand_pass" in name:
        return f"cot_operand_pass<bf16> {dx}"
    if "up_adjoint_pass" in name:
        return f"up_adjoint_pass {'(j)' if j else '(c)'}"
    if "pair_adjoint_pass" in name:
        return "pair_adjoint_pass (n)"
    if "mma_dtaps" in name:
        return f"mma_dtaps<bf16> {grid or which}"
    if "mma_conv" in name and ("DxEpi" in name or "DuEpi" in name):
        return f"mma_conv_dx<bf16> {dx}"
    if "mma_conv" in name:
        return f"mma_conv_fwd<bf16> {grid or ('(n)' if pair else '(up conv)')}"
    if "pack_taps_t" in name:
        return f"pack_taps {dx}"
    if "pack_taps" in name:
        return f"pack_taps {grid or '(up conv, n)'}"
    loader = "UpLoad" if "UpLoad" in name else "GridLoad"
    split = ", split> (m)" if "true>" in name else ">"
    if "PairCells" in name or "DxPairOut" in name:
        split = ", pair> (n)"
    if "conv_gemm" in name:
        return f"conv_gemm<{dtype}, {loader}{split}"
    if "dx_gemm" in name:
        return f"dx_gemm<{dtype}{split}"
    if "dtaps_gemm" in name:
        return f"dtaps_gemm<{dtype}, {loader}{split}"
    if "stats_geff" in name:
        return "stats_geff (l)"
    if "merged_bwd" in name:
        return f"merged_bwd<{dtype}, {loader}>"
    if "two_pass_block" in name:
        kind = "mma_" if "mma_two_pass_block" in name else ""
        return f"{kind}two_pass_block<{dtype}, {loader}> ({'o' if loader == 'UpLoad' else 'p'})"
    if "sum_rows" in name or "colsum" in name or "sum_chunks" in name:
        return "sum_rows + colsum (cross-block sums)"
    if "pair_head_kernel" in name:
        return "pair_head_kernel"
    if "phead_bwd" in name:
        return "phead_bwd (head bwd, kernel e)"
    if "phmse_bwd" in name:
        return "phmse_bwd (head+MSE bwd, kernel h)"
    if "phmse_fwd" in name:
        return "phmse_fwd (head+MSE fwd, kernel g)"
    if "phmse_poles" in name:
        return "phmse_poles (pole pass, g and h)"
    if any(w in name.lower() for w in ("cudnn", "xmma", "cutlass", "gemm", "conv")):
        return "cuDNN / cuBLAS"
    return "PyTorch ops"


def top_device_ops(events, top: int = 10) -> list[list]:
    """[[label, seconds]] of the labels that took the most device time."""
    sums: dict[str, float] = {}
    for e in events:
        label = kernel_group(e)
        sums[label] = sums.get(label, 0.0) + e["dur"] / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

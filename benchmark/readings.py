"""What a run hands to the per-layer readers (``benchmark/metrics/``).

A driver fills one ``Readings``: host times of the window's steps or
batches, the wrapper launch count, the model's operations, and the traced
stretch. Steps inside the traced stretch, and the time the profiler took,
are kept out of the host times and of the rate the operations are divided
by, so a traced run's readings are of the same loop as an untraced one.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field

from benchmark import trace
from benchmark.work import PEAK_FLOPS


@dataclass
class Readings:
    kind: str  # the traffic's kind: "train" or "recon"
    flops: float = 0.0  # the model's operations over the steps counted below
    flop_wall_s: float = 0.0  # the window's wall time outside the traced stretch
    host_ms: dict = field(default_factory=dict)  # span name -> [ms] outside the stretch
    launches: int = 0  # the program's wrapper launches over launch_steps
    launch_steps: int = 0
    stretch: trace.Stretch | None = None
    stretch_units: int = 0  # steps or batches inside the stretch
    stretch_least_s: float = 0.0  # their least time on the card (benchmark/work.py)
    port: object = frozenset()  # holds the program's kernel function names (trace.Library)

    def busy_s(self, keep=lambda e: True) -> float:
        return trace.busy_seconds(self.stretch.events, keep)

    def median_ms(self, span: str):
        values = self.host_ms.get(span)
        return statistics.median(values) if values else None

    def traced(self, kind: str) -> bool:
        return self.kind == kind and self.stretch is not None and self.stretch.events is not None

    def idle_percent(self, kind: str):
        """1 - device busy time a unit (the stretch's) / wall time a unit
        (the window's outside the stretch: the profiler slows the host that
        sets the pace, never the kernels)."""
        outside = len(self.host_ms.get("step", ()))
        if not self.traced(kind) or not outside or not self.stretch_units:
            return None
        busy = self.busy_s() / self.stretch_units
        return 100.0 * (1.0 - busy / (self.flop_wall_s / outside))

    def glue_percent(self, kind: str):
        """Device time outside the program's own kernels and outside the
        copies, as a share of busy time."""
        if not self.traced(kind):
            return None
        glue = self.busy_s(lambda e: e["cat"] == "gpu_memset"
                           or (e["cat"] == "kernel" and not trace.is_port_kernel(e, self.port)))
        return 100.0 * glue / self.busy_s()

    def roofline_percent(self, kind: str):
        if not self.traced(kind) or self.stretch_least_s <= 0:
            return None
        return 100.0 * self.stretch_least_s / self.busy_s()

    def mfu_percent(self, kind: str):
        if self.kind != kind or self.flop_wall_s <= 0:
            return None
        return 100.0 * self.flops / (self.flop_wall_s * PEAK_FLOPS)

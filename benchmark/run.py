"""The benchmark of ``geniconet_tpu_torch`` (the PyTorch and CUDA port of
GenIcoNet) on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Runs one cell of ``BENCHMARK.json``: set-up
(import, the kernel library from ``build/kernels/``, data and weights from
the seed, the program's first steps, warm-up), then ``--seconds`` of the
cell's traffic, then the comparison with the plain reference that decides
``correct``. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (a short stretch of the same window under
``torch.profiler``). The compared numbers and their limits are the last
lines of standard error and the result's last key.

Exits non-zero and prints no result without enough CUDA devices, when a
module of JAX or of the JAX package is loaded (looked for after set-up,
after the window and just before the result is printed), or when the
plain reference has loaded the program.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "geniconet_tpu")
PROGRAM = "geniconet_tpu_torch"


def loaded_tops(names=FORBIDDEN) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``names``, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in names)


class Refused(RuntimeError):
    """The run cannot give a result."""


class Hooks:
    """What a driver calls back: the end of each phase of set-up, and of
    set-up itself (the phases' seconds go to standard error)."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.setup_s = None
        self.phases = [("start", t0)]

    def mark(self, phase: str):
        self.phases.append((phase, time.perf_counter()))

    def setup_done(self):
        self.mark("warm-up")
        self.setup_s = self.phases[-1][1] - self.t0
        guard("after set-up")
        steps = zip(self.phases, self.phases[1:])
        print("setup_s " + " ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in steps),
              file=sys.stderr, flush=True)


def guard(when: str):
    found = loaded_tops()
    if found:
        raise Refused(f"{when}: modules of JAX or the JAX package are loaded: {found}")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell, args, device: str = "cuda", t0: float = T0) -> dict:
    """Run one cell on ``device`` and return the result line's object."""
    from benchmark import checks, spec, trace

    hooks = Hooks(t0)
    hooks.mark("imports")
    out = spec.driver(cell.traffic["kind"]).run(cell, args, hooks, device)
    guard("after the window")
    correct, compared = checks.judge(out["numbers"], cell.limits)
    readings = out["readings"]
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if args.trace:
        from geniconet_tpu_torch.ops.kernels import build

        readings.port = trace.Library(build.library()._name)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out["end_to_end"], "setup_s": hooks.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info(device, out["memory_peak_bytes"], cell.chips)
    stretch = readings.stretch
    if args.trace and stretch is not None:
        result["device"].update(busy_s=readings.busy_s(), window_s=stretch.wall_s)
        result["breakdown"] = {"device_ops": trace.top_device_ops(stretch.events),
                               "idle_gaps": trace.idle_gaps(stretch)}
    result["compared"] = compared
    return result


def device_info(device: str, peak: int, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak, "power_limit": power_limit()}


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import torch

        from benchmark import spec

        cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise Refused(f"{args.workload} needs {cell.chips} CUDA device(s); "
                          f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        import benchmark.reference.quant  # noqa: F401  (the reference before the program)
        import benchmark.reference.train  # noqa: F401

        if loaded_tops((PROGRAM,)):
            raise Refused(f"the plain reference loaded the program: {loaded_tops((PROGRAM,))}")
        guard("at start")
        result = run_cell(cell, args)
        guard("before the result")  # the per-layer readers ran after the window's guard
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    for name, c in result["compared"].items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']!r}"
        print(f"{name} {c['value']!r} {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

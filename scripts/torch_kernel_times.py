#!/usr/bin/env python3
"""Times of chosen bf16 kernel wrappers on one CUDA GPU, at the s=5 models' shapes.

    python3 scripts/torch_kernel_times.py --kernels NAME[,NAME...] [--root DIR] [--cases DIR]
        [--reps N]

Takes the kernel cases of ``chip_smoke.py`` (``serving_cases`` at B=16 and
``training_cases`` at B=36; widths 64/128/256, the VAE's latent 512) whose
kernel is named in ``--kernels`` (``chip_smoke.KERNELS``' names, e.g.
``phase_conv_fwd,ico_conv_s2s_fwd``), builds each in bf16, and prints per
case three medians over ``--reps`` calls after warm-ups: the CUDA-event
time of one call (the wrapper's host time included), the device time of
one call's kernels from a ``torch.profiler`` trace, and the host time of
one call (the wall time to return, with the device idle before it: the
wrapper's checks, allocations and launches); where the case has them,
its parts from a trace, as ``chip_smoke.py`` prints them (a
tensor-core kernel's operand pass, GEMM TFLOP/s and sums; the pair head's
forwards' and backwards' main pass GB/s against its byte bound); then the
sums per kernel, phase (serving, training) and group of shapes (AE, AE no
act, VAE, chain). ``--root`` names the checkout whose ``chip_smoke.py`` and
``geniconet_tpu_torch`` are imported (default: the one this script is
in), so two commits can be timed on one card, each in its own process: run
the old tree, the new, the new, the old. ``--cases`` names the checkout
whose ``chip_smoke.py`` supplies the cases (default: ``--root``), so an old
tree can be timed at the shapes a newer ``chip_smoke.py`` adds.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import statistics
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", required=True)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--cases", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: needs a CUDA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(args.cases or args.root).resolve() / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    card, names = cs.card_line(), set(args.kernels.split(","))

    def host_ms(fn):
        fn()
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = collections.defaultdict(lambda: [0.0, 0.0, 0.0])
    for phase, cases in (("serving", cs.serving_cases()), ("training", cs.training_cases())):
        for name, label, make, group in cases:
            if name not in names:
                continue
            case = make(torch.bfloat16, gen)
            fn = case.kernel
            ms = (cs.cuda_ms(fn, args.reps), sum(cs.trace_kernels(fn, args.reps).values()),
                  host_ms(fn))
            for key in ((name, phase, group), (name, phase, "all"), (name, "all", "all")):
                sums[key] = [a + b for a, b in zip(sums[key], ms)]
            print(f"[kernel times] {name} {phase} {group}: {label} bf16 one call {ms[0]:.4f} ms "
                  f"(CUDA events), device {ms[1]:.4f} ms (trace), host {ms[2]:.4f} ms [{card}]",
                  flush=True)
            if case.parts is not None:
                parts = ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in case.parts().items())
                print(f"[kernel parts] {name} {phase} {group}: {label} bf16 {parts} [{card}]",
                      flush=True)
            del fn, case
    for (name, phase, group), (ms, dev, host) in sums.items():
        print(f"[kernel times sum] {name} {phase} {group}: {ms:.4f} ms (CUDA events), device "
              f"{dev:.4f} ms, host {host:.4f} ms [{card}]", flush=True)


if __name__ == "__main__":
    main()

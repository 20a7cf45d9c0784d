#!/usr/bin/env python3
"""Peak device memory and time of bf16 training steps of the PyTorch port on one CUDA GPU.

    python3 scripts/torch_step_memory.py [--root DIR] [--steps N] [--requests N]

Trains the AE and the VAE (latent 512) at s=5, widths 64/128/256, B=36 on 36
synthetic meshes with seeded random weights, on the default routing and, for
the AE, on the merged backward (``merged_bwd="all"``), the decoder's chain
(``phase_chain="dec"``), both chains (``"1"``) and the merged blocks
(``merged_block="all"``: kernels o and p), and prints per model and
routing: ``torch.cuda.max_memory_allocated()`` over the steps (after
``reset_peak_memory_stats``), the median host-clock step time,
synchronised, the median time ``train_step`` takes to return (the host's
enqueue, before the synchronise), and the device busy time a step (the
union of the device events of a ``torch.profiler`` trace of 3 steps) with
the idle share 1 - busy / step. Then serves the AE in bf16 (``AppState`` on 32 synthetic
meshes) and prints the p50 host-clock latency of ``decode_latent`` (one
mesh, latent in, vertices out) over ``--requests`` requests after 10, and
the median CUDA-event time of encode+decode at B=16 over 20 after 3
(with ``--steps 0`` alone), each with its device busy time (a trace of
10). ``--root`` names the checkout whose ``geniconet_tpu_torch`` is imported
(default: the one this script is in), so two commits can be compared on one
card, each in its own process: run the old tree, the new, the new, the old.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--requests", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_step_memory: needs a CUDA GPU")
    from geniconet_tpu_torch import Config, bridge
    from geniconet_tpu_torch.data.datasets import synthetic_dataset
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.train.trainer import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dataset = synthetic_dataset(5, 36, seed=0)
    runs = (("ico2ico", {}), ("ico2ico", {"merged_bwd": "all"}),
            ("ico2ico", {"phase_chain": "dec"}), ("ico2ico", {"phase_chain": "1"}),
            ("ico2ico", {"merged_block": "all"}), ("ico2ico_vae", {}))
    for model, routing in runs if args.steps > 0 else ():  # --steps 0: serving alone
        cfg = Config()
        cfg.model.name, cfg.model.subdivisions, cfg.model.widths = model, 5, (64, 128, 256)
        cfg.model.latent_features, cfg.model.compute_dtype = 512, "bfloat16"
        cfg.train.batch_size = 36
        variables = bridge.init_variables(5, (64, 128, 256), seed=1, model=model,
                                          latent_features=512)
        tr = Trainer(cfg, device="cuda", **routing)
        st = tr.init_state(variables)
        x, y, wt = next(iter(Batches(dataset, 36, drop_remainder=True, seed=0,
                                     device="cuda").epoch()))
        tr.train_step(st, x, y, wt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, returns = [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            tr.train_step(st, x, y, wt)
            returns.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        step = statistics.median(times)
        busy = device_busy_ms(lambda: tr.train_step(st, x, y, wt), 3)
        print(f"[step memory] {args.root} {model} {routing or 'default'} bf16 B=36: peak "
              f"max_memory_allocated {peak} bytes ({peak / 2**20:.1f} MiB); step "
              f"{step:.3f} ms (median of {args.steps}, host clock, synchronised), "
              f"train_step returns after {statistics.median(returns):.3f} ms (host enqueue); "
              f"device busy {busy:.3f} ms a step (trace of 3), idle share "
              f"{1 - busy / step:.4f} [{card}]", flush=True)
        del tr, st
        torch.cuda.empty_cache()
    serving(args, card)


def device_busy_ms(fn, iters):
    """Device busy time per call of fn(): the union of the kernel, memcpy and
    memset intervals of a torch.profiler trace of ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA")
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3 / iters


def serving(args, card):
    """The AE's bf16 serving latency: B=1 decode p50 and B=16 encode+decode."""
    import torch

    from geniconet_tpu_torch import Config, bridge
    from geniconet_tpu_torch.app.state import AppState

    cfg = Config()
    cfg.model.name, cfg.model.subdivisions, cfg.model.widths = "ico2ico", 5, (64, 128, 256)
    cfg.model.compute_dtype = "bfloat16"
    cfg.data.synthetic = 32
    st = AppState(device="cuda")
    st.load(cfg, variables=bridge.init_variables(5, (64, 128, 256), seed=0, random_stats=True))
    lat = []
    for i in range(10 + args.requests):
        t0 = time.perf_counter()
        st.decode_latent(st.latents[i % 32])
        lat.append((time.perf_counter() - t0) * 1e3)
    x = torch.as_tensor(st.dataset.inputs[:16], device="cuda")
    times = []
    with torch.inference_mode():
        for i in range(23):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            st.model.decode(st.model.encode(x))
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        busy16 = device_busy_ms(lambda: st.model.decode(st.model.encode(x)), 10)
    busy1 = device_busy_ms(lambda: st.decode_latent(st.latents[0]), 10)
    p50 = statistics.median(lat[10:])
    print(f"[serving] {args.root} ico2ico bf16: p50 decode_latent {p50:.3f} ms (host clock, "
          f"{args.requests} requests), device busy {busy1:.4f} ms a decode (trace of 10); "
          f"encode+decode B=16 {statistics.median(times):.3f} ms (median of 20, CUDA events), "
          f"device busy {busy16:.4f} ms (trace of 10) [{card}]", flush=True)


if __name__ == "__main__":
    main()

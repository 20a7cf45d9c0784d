#!/usr/bin/env python3
"""Peak device memory and time of bf16 training steps of the PyTorch port on one CUDA GPU.

    python3 scripts/torch_step_memory.py [--root DIR] [--steps N]

Trains the AE and the VAE (latent 512) at s=5, widths 64/128/256, B=36 on 36
synthetic meshes with seeded random weights, on the default routing and on
the decoder's chain (``phase_chain="dec"``, AE), and prints per model and
routing: ``torch.cuda.max_memory_allocated()`` over the steps (after
``reset_peak_memory_stats``) and the median host-clock step time,
synchronised. ``--root`` names the checkout whose ``geniconet_tpu_torch`` is
imported (default: the one this script is in), so two commits can be
compared on one card, each in its own process: run the old tree, the new,
the new, the old.
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
    for model, chain in (("ico2ico", None), ("ico2ico", "dec"), ("ico2ico_vae", None)):
        cfg = Config()
        cfg.model.name, cfg.model.subdivisions, cfg.model.widths = model, 5, (64, 128, 256)
        cfg.model.latent_features, cfg.model.compute_dtype = 512, "bfloat16"
        cfg.train.batch_size = 36
        variables = bridge.init_variables(5, (64, 128, 256), seed=1, model=model,
                                          latent_features=512)
        tr = Trainer(cfg, device="cuda", phase_chain=chain)
        st = tr.init_state(variables)
        x, y, wt = next(iter(Batches(dataset, 36, drop_remainder=True, seed=0,
                                     device="cuda").epoch()))
        tr.train_step(st, x, y, wt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            tr.train_step(st, x, y, wt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        print(f"[step memory] {args.root} {model} phase_chain={chain!r} bf16 B=36: peak "
              f"max_memory_allocated {peak} bytes ({peak / 2**20:.1f} MiB); step "
              f"{statistics.median(times):.3f} ms (median of {args.steps}, host clock, "
              f"synchronised) [{card}]", flush=True)
        del tr, st
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

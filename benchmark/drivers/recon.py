"""Reconstruction traffic: the program's ``eval/test_driver.py:reconstruct``
over a split held in host memory, as ``--process test`` runs it: batches
in order (the last one ragged), each copied to the card, reconstructed in
eval mode and its vertices copied back to the host, one batch in flight,
pass after pass until the window's time is up.

A batch's latency (``recon_p95_ms``) runs from taking its grids off the
host to holding its vertices on the host. The model is the program's ``Trainer`` model with the
seed's weights and BatchNorm statistics, in eval mode.

``correct``: one mesh of about every ``sample_every``-th batch, both
drawn from the seed, is kept as the window produced it and compared with
the reference's reconstruction once the window has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks, data, weights, work
from benchmark.drivers.common import (
    Seeds, Tracer, free, memory_peak, program_config, program_starts, sync,
)
from benchmark.readings import Readings
from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model


def run(cell, args, hooks, device: str = "cuda") -> dict:
    from geniconet_tpu_torch.bridge import state_dict_to_flax
    from geniconet_tpu_torch.eval.test_driver import reconstruct
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.train.trainer import Trainer

    t, c = cell.traffic, cell.config
    s, B, N = t["subdivisions"], t["batch_size"], t["pool"]
    dev = torch.device(device)
    seeds = Seeds.of(args.seed)
    grids = data.grids(data.vertices(s, N, seeds.data, dev), s)
    params0 = weights.running_stats(c, weights.make(c, seeds.weights, dev, random_stats=True),
                                    grids[:B], s)
    pool = grids.cpu().numpy()
    del grids
    program_starts(dev)
    hooks.mark("data")
    trainer = Trainer(program_config(cell), device=dev)
    trainer.init_state(state_dict_to_flax(params0), seed=seeds.trainer)
    model = trainer.model.eval()
    hooks.mark("trainer")
    starts = list(range(0, N, B))

    def one(i0):
        """One batch: (its vertices on the host, its spans)."""
        t0 = time.perf_counter_ns()
        x = torch.as_tensor(pool[i0 : i0 + B], device=dev)
        t1 = time.perf_counter_ns()
        with torch.no_grad():
            v = reconstruct(model, x)
        t2 = time.perf_counter_ns()
        host = v.cpu()
        t3 = time.perf_counter_ns()
        return host, (("copy", t0, t1), ("step", t1, t2), ("copy", t2, t3))

    for i0 in sorted({starts[0], starts[-1]}):  # each batch shape, twice
        one(i0)
        one(i0)
    sync(dev)
    rng = np.random.RandomState(seeds.sample)
    hooks.setup_done()

    window_ns = int(args.seconds * 1e9)
    tracer = Tracer(args.trace, t["trace_batches"], window_ns)
    flops = {n: work.step_flops(c, s, n, False) for n in {B, N - starts[-1]}}
    least = {n: work.step_least_seconds(c, s, n, False) for n in flops}
    latencies, enqueue, kept = [], [], []
    meshes = batches = 0
    counted_flops = 0.0
    launches0 = sum(build.LAUNCHES.values())
    t_start = time.perf_counter_ns()
    deadline = t_start + window_ns
    while time.perf_counter_ns() < deadline:
        k = batches % len(starts)
        i0 = starts[k]
        host, spans = one(i0)
        n = host.shape[0]
        batches += 1
        meshes += n
        if rng.randint(t["sample_every"]) == 0:
            row = rng.randint(n)
            kept.append((i0 + row, host[row]))
        if not tracer.record(spans, least[n]):
            latencies.append((spans[-1][2] - spans[0][1]) / 1e6)
            enqueue.append((spans[1][2] - spans[1][1]) / 1e6)
            counted_flops += flops[n]
        tracer.boundary(spans[-1][2] - t_start, k == len(starts) - 1)
    sync(dev)
    window_s = (time.perf_counter_ns() - t_start) / 1e9
    tracer.close()
    launches = sum(build.LAUNCHES.values()) - launches0
    peak = memory_peak(dev)

    del trainer, model
    free(dev)
    idx = [i for i, _ in kept]
    prog = torch.stack([v for _, v in kept]).to(dev) if kept else None
    ref = []
    with torch.no_grad(), ref_model.exact_float32():
        for j in range(0, len(idx), B):
            x = torch.as_tensor(pool[idx[j : j + B]], device=dev)
            if c["model"]["name"].endswith("_vae"):  # reconstruct decodes mu
                grid = ref_model.vae(params0, x, s, False)[0]
            else:
                grid = ref_model.autoencoder(params0, x, s, False)
            ref.append(ref_loss.grid_to_vertices(grid, s))
    numbers = (checks.reconstruction(prog, torch.cat(ref)) if kept
               else {"recon_err": float("nan")})

    stretch = tracer.result()
    readings = Readings("recon", flops=counted_flops,
                        flop_wall_s=window_s - tracer.excluded_ns / 1e9,
                        host_ms={"step": enqueue, "batch": latencies}, launches=launches,
                        launch_steps=batches,
                        stretch=stretch, stretch_units=t["trace_batches"] if stretch else 0,
                        stretch_least_s=tracer.least)
    return {"end_to_end": {"recon_meshes_per_s": meshes / window_s},
            "readings": readings, "attempted": meshes, "failed": 0,
            "memory_peak_bytes": peak, "numbers": numbers}

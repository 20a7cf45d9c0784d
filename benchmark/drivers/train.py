"""Training traffic: the program's ``Trainer.train_epoch``, epoch after
epoch, over a pool of synthetic meshes held on the card and reshuffled by
the program's ``Batches`` every epoch.

Set-up builds the one ``Trainer`` and its Adam state from the seed's
weights and drives them through the run's first steps by ``train_epoch``
itself, one call a step, on epoch 0's first batches: those are the steps
the reference follows. A log cycle of further steps warms the loop and a
step on the epoch's ragged last batch warms that shape; then the window
runs epoch 1 on. A wrapper around ``Batches.epoch()`` times each batch's
fetch and the step the trainer takes on it, and ends the epoch when the
window's time is up, so a run lasts its seconds plus at most one step.
"""

from __future__ import annotations

import itertools
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import checks, data, weights, work
from benchmark.drivers.common import (
    Seeds, Tracer, free, memory_peak, program_config, program_starts, sync,
)
from benchmark.readings import Readings
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train


class _Take:
    """The next ``n`` batches (or fewer, at the epoch's end) of an open
    ``Batches.epoch()`` iterator, as a loader ``train_epoch`` can iterate."""

    def __init__(self, it, n: int):
        self.it, self.n, self.taken = it, n, 0

    def epoch(self):
        for batch in itertools.islice(self.it, self.n):
            self.taken += 1
            yield batch


class _Feed:
    """The window's loader: ``Batches.epoch()``, timed, until the deadline."""

    def __init__(self, batches, cell, tracer: Tracer, step0: int):
        self.batches, self.tracer = batches, tracer
        self.s, self.cfg = cell.traffic["subdivisions"], cell.config
        self.log_freq = cell.config["log_freq"]
        self.step = step0  # updates made, set-up's included
        self.t0 = self.deadline = 0
        self.done = False
        self.meshes = self.steps = 0
        self.flops = 0.0
        self.host_ms = {"data": [], "step": []}
        self._work = {}

    def _count(self, B: int):
        if B not in self._work:
            self._work[B] = (work.step_flops(self.cfg, self.s, B, True),
                             work.step_least_seconds(self.cfg, self.s, B, True))
        return self._work[B]

    def epoch(self):
        it = self.batches.epoch()
        while True:
            t0 = time.perf_counter_ns()
            if t0 >= self.deadline:
                self.done = True
                return
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter_ns()
            yield batch
            t2 = time.perf_counter_ns()
            B = batch[0].shape[0]
            self.step += 1
            self.steps += 1
            self.meshes += B
            flops, least = self._count(B)
            if not self.tracer.record((("data", t0, t1), ("step", t1, t2)), least):
                self.flops += flops
                self.host_ms["data"].append((t1 - t0) / 1e6)
                self.host_ms["step"].append((t2 - t1) / 1e6)
            # the trainer synced the device after the step (step - 1) % log_freq == 0
            self.tracer.boundary(t2 - self.t0, (self.step - 1) % self.log_freq == 0)


def _first_moment(optimizer, p) -> torch.Tensor:
    """Adam's first moment of p (zeros where it holds none: it never
    received a gradient)."""
    m = optimizer.state.get(p, {}).get("exp_avg")
    return torch.zeros_like(p) if m is None else m.detach().clone()


def _batch_moments(model, params0: dict) -> dict:
    """{BatchNorm name: (mean, var)} of the batch of the step just taken,
    read back from the running statistics, which keep ``BN_MOMENTUM`` of
    their initial values."""
    buffers = dict(model.named_buffers())
    m = ref_model.BN_MOMENTUM
    return {name[: -len(".mean")]: tuple(
        (buffers[f"{name[: -len('.mean')]}.{leaf}"].detach() - m * params0[
            f"{name[: -len('.mean')]}.{leaf}"]) / (1 - m) for leaf in ("mean", "var"))
        for name in buffers if name.endswith(".mean")}


def setup(cell, seeds: Seeds, dev: torch.device, warm: bool = True,
          mark=lambda phase: None) -> SimpleNamespace:
    """The pool, the weights, the ``Trainer`` and its state, driven through
    the checked steps (their losses, the first gradient as Adam received
    it, each parameter's change), then, with ``warm``, warmed up; ``mark``
    is called at the end of each phase."""
    from geniconet_tpu_torch.bridge import state_dict_to_flax
    from geniconet_tpu_torch.data.datasets import IcoDataset
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.train.trainer import Trainer

    t, c = cell.traffic, cell.config
    s, B, N = t["subdivisions"], t["batch_size"], t["pool"]
    v = data.vertices(s, N, seeds.data, dev)
    pool_x, pool_y = data.grids(v, s), data.targets(v, s)
    del v
    params0 = weights.make(c, seeds.weights, dev)
    program_starts(dev)
    mark("data")
    trainer = Trainer(program_config(cell), device=dev)
    state = trainer.init_state(state_dict_to_flax(params0), seed=seeds.trainer)
    batches = Batches(IcoDataset(pool_x, pool_y, subdivisions=s), B, shuffle=True,
                      seed=seeds.shuffle, device=dev)
    mark("trainer")
    named = dict(trainer.model.named_parameters())
    b1 = c["optim"]["b1"]
    it = batches.epoch()
    losses, grad1, moments1 = [], None, None
    for k in range(t["checked_steps"]):
        state, info = trainer.train_epoch(state, _Take(it, 1), c["kl_epoch"])
        losses.append(info["last_device"]["total"].detach().float().clone())
        if k == 0:  # the gradient as Adam received it: its first moment / (1 - b1)
            grad1 = {n: _first_moment(state.optimizer, p) / (1 - b1) for n, p in named.items()}
            moments1 = _batch_moments(trainer.model, params0)
    delta = {n: p.detach().clone() - params0[n] for n, p in named.items()}
    sync(dev)
    mark("checked steps")
    steps = t["checked_steps"]
    if warm:  # a log cycle of steps, then the epoch's ragged last batch
        take = _Take(it, c["log_freq"])
        state, _ = trainer.train_epoch(state, take, c["kl_epoch"])
        steps += take.taken
        last = None
        for last in it:
            pass
        if last is not None and last[0].shape[0] != B:
            state, _ = trainer.train_epoch(state, _Take(iter([last]), 1), c["kl_epoch"])
            steps += 1
        del last
    return SimpleNamespace(trainer=trainer, state=state, batches=batches, steps=steps,
                           losses=losses, grad1=grad1, moments1=moments1, delta=delta,
                           params0=params0,
                           pool_x=pool_x, pool_y=pool_y)


def reference_inputs(cell, seeds: Seeds, pool_x, pool_y, dev):
    """The checked steps' batches, from the shuffle worked out again
    (``np.random.RandomState(seed).shuffle`` of the pool's indices, as
    ``Batches`` draws it), and the VAE's eps of each step (the trainer's
    generator: seeded with its seed + 2 on the device, one draw a step)."""
    t, c = cell.traffic, cell.config
    s, B, N = t["subdivisions"], t["batch_size"], t["pool"]
    order = np.arange(N)
    np.random.RandomState(seeds.shuffle).shuffle(order)
    rows = [torch.as_tensor(order[k * B : (k + 1) * B], device=dev)
            for k in range(t["checked_steps"])]
    batches = [(pool_x[i].clone(), pool_y[i].clone()) for i in rows]
    eps = None
    if c["model"]["name"].endswith("_vae"):
        gen = torch.Generator(device=dev).manual_seed(seeds.trainer + 2)
        zc, H, W = c["model"]["latent_features"], 5 * 2 ** (s - 3), 2 ** (s - 2)
        eps = [torch.randn((len(i), H, W, zc), generator=gen, device=dev) for i in rows]
    return batches, eps


def followed(cell, params0, batches, eps, q=None) -> dict:
    """The reference's (or, with ``q``, the control's) run of the checked
    steps: losses, first gradient and each parameter's change."""
    kw = {} if q is None else {"q": q}
    out = ref_train.follow(cell.config, params0, batches, cell.traffic["subdivisions"], eps, **kw)
    out["delta"] = {n: out["params"][n] - params0[n] for n in out["params"]}
    return out


def compare(run: dict, ref: dict) -> dict:
    """The numbers of a run of the checked steps (a dict of ``losses``,
    ``grad1``, ``moments1`` and ``delta``) against the reference's."""
    return checks.training(run["losses"], ref["losses"], run["grad1"], ref["grad1"],
                           run["delta"], ref["delta"], run["moments1"], ref["moments1"])


def run(cell, args, hooks, device: str = "cuda") -> dict:
    from geniconet_tpu_torch.ops.kernels import build

    dev = torch.device(device)
    seeds = Seeds.of(args.seed)
    st = setup(cell, seeds, dev, mark=hooks.mark)
    trainer, state = st.trainer, st.state
    sync(dev)
    hooks.setup_done()

    window_ns = int(args.seconds * 1e9)
    log_freq = cell.config["log_freq"]
    units = -(-cell.traffic["trace_steps"] // log_freq) * log_freq
    tracer = Tracer(args.trace, units, window_ns)
    feed = _Feed(st.batches, cell, tracer, st.steps)
    launches0 = sum(build.LAUNCHES.values())
    feed.t0 = time.perf_counter_ns()
    feed.deadline = feed.t0 + window_ns
    epoch = cell.config["kl_epoch"] + 1
    while not feed.done:
        state, _ = trainer.train_epoch(state, feed, epoch)
        epoch += 1
    sync(dev)
    window_s = (time.perf_counter_ns() - feed.t0) / 1e9
    tracer.close()
    peak = memory_peak(dev)
    stretch = tracer.result()
    readings = Readings("train", flops=feed.flops,
                        flop_wall_s=window_s - tracer.excluded_ns / 1e9, host_ms=feed.host_ms,
                        launches=sum(build.LAUNCHES.values()) - launches0,
                        launch_steps=feed.steps, stretch=stretch,
                        stretch_units=units if stretch else 0, stretch_least_s=tracer.least)
    meshes = feed.meshes

    # the reference follows the checked steps on the same rows, once the
    # program's state is freed
    ref_batches, eps = reference_inputs(cell, seeds, st.pool_x, st.pool_y, dev)
    prog, params0 = checked(st), st.params0
    del st, trainer, state, feed
    free(dev)
    ref = followed(cell, params0, ref_batches, eps)
    return {"end_to_end": {"train_meshes_per_s": meshes / window_s},
            "readings": readings, "attempted": meshes, "failed": 0,
            "memory_peak_bytes": peak, "numbers": compare(prog, ref)}


def checked(st: SimpleNamespace) -> dict:
    """What the program's checked steps produced, as ``compare`` takes it."""
    return {"losses": [float(x) for x in st.losses], "grad1": st.grad1,
            "moments1": st.moments1, "delta": st.delta}
